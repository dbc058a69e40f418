"""Plain references that decide a run's ``correct``: all-pairs SNP distances
(``distances``), the recombination filter (``recomb``) and the transmission
model (``transmission``), in NumPy, SciPy and plain PyTorch operations.  They
recompute everything from the benchmark's generated inputs and import
nothing of the program under test.
"""
