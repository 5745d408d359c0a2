"""Plain references of the benchmark's configurations, one module per
configuration, and tt_check, which judges a returned train against one.
They import numpy and torch alone: nothing of the program."""
