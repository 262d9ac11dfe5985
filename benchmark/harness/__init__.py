"""The benchmark harness: cells from data, traffic, the system under test, traces, metrics, the check."""
