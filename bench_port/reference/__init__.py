"""The benchmark's plain reference of multi-conformer pre-training: PNA,
the flat Net3D, NT-Xent with several positives and Adam, in plain PyTorch
and float32, written from the published models.  It imports neither the
port nor anything of JAX, batches the raw molecules itself and takes only
the weights the benchmark makes from the seed."""
