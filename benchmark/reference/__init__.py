"""The benchmark's plain reference: a frozen copy of the port's model, steps
and optimizer on their plain PyTorch path (no kernel, one process), run in
float32. It imports nothing of the port; the benchmark hands it the same
weights, batches and draws as the program and compares what they give."""
