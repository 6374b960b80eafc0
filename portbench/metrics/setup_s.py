"""Process start to the first timed step: imports, the kernels loaded
(built with nvcc in a checkout's first run, which the result's ``build_s``
shows apart), weights made on the card from the seed, the warm-up of the
cell's own shapes and the cache its traffic needs."""


def read(run):
    return run.setup_s
