"""One intra-op thread for torch in a test process of the port's CPU suite.

The tier-1 suite runs as several pytest workers on one host. torch's
default gives each worker one OpenMP thread per core, so six workers keep
about six threads per core busy, and threads that spin while they wait
for each other turn that into waiting: on an 8-core host, six of the
adamw loss-curve checks run side by side took 97-108 s each with the
default and 8.5-10.1 s with one thread. The checks and their inputs are
the same either way; every comparison between two torch runs in a test is
made in one process, at one thread count.

Every ``tests/test_torch_*.py`` imports this module (the spawned ranks
and CLI processes already set ``OMP_NUM_THREADS=1``).
"""

import torch

torch.set_num_threads(1)
