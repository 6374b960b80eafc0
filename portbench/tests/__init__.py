"""CPU tests of the benchmark: ``python -m pytest portbench/tests`` from the
root of the repository (the repository's ``testpaths`` leave them out of a
plain ``pytest`` run)."""
