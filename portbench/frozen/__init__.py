"""Frozen copies of the program's arithmetic that the benchmark measures
with: the peaks, the flash kernel's work and the model FLOPs. Each file
names what it was copied from. Later changes to the program do not move
these, so a metric reads the same work whatever implements it."""
