"""The port's tests run torch on one CPU thread.

Their tensors are small, so torch's pool of OpenMP threads buys them
nothing, and it costs the processes beside them: the pool's threads spin
at the end of each parallel region, and a pool as wide as the machine in
each of the test run's processes (``pytest -n``) takes the cores from the
JAX tests running in the others.  pytest imports every test module of a
run before it runs the first test, so the count set here at import holds
for every test of the process.  A subprocess a test starts sets its own.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1
