"""World 7 of the JAX package's own tests through the port: the first two
cells of the accuracy sweep's quick grid (``tests/test_accuracy.py::
test_quick_grid_floors``, seed 7); the third is in
``tests/test_torch_world_sweep.py``, which keeps each file near a minute.

``scripts/torch_accuracy_sweep.py`` is the port's copy of
``scripts/accuracy_sweep.py``; both are loaded as ``tests/test_accuracy.py``
loads the JAX one. Per cell, the port's call set under ``scan`` equals the
JAX package's under ``scan``, and clears the JAX test's floors.
"""

import pytest
import torch

torch.set_num_threads(1)

import torch_worlds as W

sweep = W.load_script("accuracy_sweep")
tsweep = W.load_script("torch_accuracy_sweep")


@pytest.mark.parametrize("i", [0, 1])
def test_quick_grid_cell_equals_the_jax_calls_and_clears_the_floors(i):
    W.check_quick_cell(sweep, tsweep, i)
