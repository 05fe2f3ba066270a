"""The plain reference of the benchmark: a frozen copy of the plain
PyTorch versions of ``piecewise_icp_torch`` (commit 16bbac6), the pair
path, adaptive planning, chaining and Kalman smoothing.

It imports nothing of ``piecewise_icp_torch``, ``piecewise_icp_tpu`` or
``jax``.  Against the port's modules it differs only where the port calls a
hand-written kernel: every grid or brute neighbour search, segmentation
statistic and label propagation here runs its plain version on whatever
device its tensors are on (``ops/nn.py`` and ``ops/seg.py``, copies of
``ops/nn_cuda.py`` and ``ops/seg_cuda.py`` without the kernel wrappers).
Reports, views, the profiler switch and the sharded paths' helpers are
left out.  The benchmark runs it on the card after the measured window,
with TF32 off as the port runs (``device.py``), to judge what the timed
path produced; a later change to the port does not change this copy.
"""
