"""Training: the train step (loss, grads, compression, optimizer) and the
checkpointed, restartable runner."""
