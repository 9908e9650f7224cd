"""Plain references the benchmark holds the program to; none imports the
program."""
