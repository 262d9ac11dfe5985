"""``step.mfu``'s reading in an open-loop cell below its knee, where it moves
the latencies and not the tokens per second (the offered rate sets those)."""
from harness.metrics import reader

read = reader("step.mfu")
