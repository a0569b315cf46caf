"""Keeps PyTorch to one intra-op thread in a test process.

The suite runs in several pytest-xdist workers at once and the port's
tests work on small tensors.  With PyTorch's default of one thread per
core, every worker's thread pool spins on the cores that the other
workers and the reference's multi-device subprocesses need, and a test
file of the port takes several times the CPU time, and longer on the
clock, than on one thread.  The ``test_torch_*`` files import this module;
under xdist every worker imports every test file while it collects, so the
setting holds in each worker before its first test."""
import torch

torch.set_num_threads(1)
