"""``device_ops_per_step`` of a predict step (``benchmark/harness/readers.py``)."""
from benchmark.harness.readers import for_file

read = for_file(__file__)
