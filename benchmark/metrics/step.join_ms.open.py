"""``step.join_ms``'s reading in the open-loop cell, where a join's length
moves the latencies (a step is a join and a chunk) and not the tokens per
second (the offered rate sets those)."""
from harness.metrics import reader

read = reader("step.join_ms")
