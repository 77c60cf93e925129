"""Frame cross-entropy training of the multi-stream LSTMP nets:
loss.py (masked losses, LossStats), optim.py (nnet1 SGD + momentum),
streams.py (multi-stream truncated-BPTT batches), trainer.py (the step
and the epoch loop), checkpoint.py (train state in the JAX package's
.npz layout)."""
