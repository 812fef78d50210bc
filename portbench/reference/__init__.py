"""Plain PyTorch references of the benchmark's configurations and the counts
of operations and bytes the benchmark holds the program to. Nothing here
imports the measured program."""
