"""The benchmark's plain reference of a configuration's training steps:
its models, loss and learning-rate schedule, each a file found by name
(`models/`, `losses/`, `schedules/`; the first are PNA, the flat Net3D,
NT-Xent with several positives and a linear warm-up), and Adam, in plain
PyTorch and float32, written from the published models.  It imports
neither the port nor anything of JAX, batches the raw molecules itself
and takes only the weights the benchmark makes from the seed."""
