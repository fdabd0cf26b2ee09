"""How the benchmark builds and drives each algorithm of the program, found by the configuration's ``algorithm``."""
