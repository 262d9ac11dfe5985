"""``engine.occupancy``'s reading (the mean share of the engine's slots
occupied at each chunk of the window, in percent) in the open-loop cells,
where it moves the time to the first token rather than the tokens a
second."""
from harness.metrics import reader

read = reader("engine.occupancy")
