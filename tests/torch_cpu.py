"""PyTorch on the CPU for the port's tests: one intra-op thread a process.

The suite is often run in several worker processes at once
(pytest-xdist, ``-n 6``).  With torch's default, each worker's op-level
thread pool takes every core of the host, and six such pools
oversubscribed its cores: the six heaviest port test files took 323 s
under six workers on an 8-core host, and 137 s with one thread a process
(a third of the CPU time).  Every port test module imports this one, and
a worker imports every test module when it collects, so a whole run is
single-threaded in torch.  The tests' results do not depend on it: they
passed under both settings.
"""
import torch

torch.set_num_threads(1)
