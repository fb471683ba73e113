"""The benchmark's plain reference: plain PyTorch and NumPy that works out
each cell's audio track and frames again from the inputs the benchmark
made. It imports nothing of the measured program (``metalrenderer_tpu_torch``)
and nothing of JAX; its modules are frozen copies of the port's oracle
path, so a later change to the program leaves them as they are."""
