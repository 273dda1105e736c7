"""Host utilities: the evaluator's array layer, the metrics logger and the
step timer."""
