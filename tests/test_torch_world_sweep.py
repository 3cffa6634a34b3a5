"""World 7 of the JAX package's own tests through the port, continued: the
port's accuracy sweep (``scripts/torch_accuracy_sweep.py``) draws the JAX
sweep's worlds; the quick grid's third cell (seed 7) gives the JAX
package's calls; and on the cross-backend cell of
``tests/test_accuracy.py::test_scan_pallas_call_concordance`` (seed 11) the
port's kernels, with genome tables as ``api.call_snps`` runs them, give the
call set of its ``scan`` twin.
"""

import numpy as np
import torch

torch.set_num_threads(1)

import torch_worlds as W

sweep = W.load_script("accuracy_sweep")
tsweep = W.load_script("torch_accuracy_sweep")


def test_build_world_draws_the_jax_sweeps_reads():
    cell = tsweep.QUICK_GRID[0]
    _, jtrue, jref, jreads, jtruth = sweep.build_world(sweep.QUICK_GRID[0], 7)
    _, true, ref, reads, truth = tsweep.build_world(cell, 7)
    assert truth == jtruth
    np.testing.assert_array_equal(true["ref"].codes, jtrue["ref"].codes)
    np.testing.assert_array_equal(ref["ref"].codes, jref["ref"].codes)
    W.assert_same_reads(jreads, reads)
    assert [(c.coverage, c.noise, c.density) for c in tsweep.FULL_GRID] == \
           [(c.coverage, c.noise, c.density) for c in sweep.FULL_GRID]


def test_quick_grid_third_cell_equals_the_jax_calls_and_clears_the_floors():
    W.check_quick_cell(sweep, tsweep, 2)


def test_kernels_give_the_scan_twins_calls_on_the_concordance_cell():
    import nadavca_tpu_torch as nt

    cell = tsweep.Cell(coverage=8, noise=0.9, density=1 / 800, read_len=400,
                       genome_len=4000)
    cfg = nt.AlignConfig(kernel_unroll=1)
    world = tsweep.prepare(cell, 11)
    m_scan, scan = tsweep.run_cell(cell, "scan", seed=11, cfg=cfg, world=world)
    m_cuda, cuda = tsweep.run_cell(cell, "cuda", seed=11, cfg=cfg, world=world)
    assert scan == cuda, sorted(scan ^ cuda)
    assert m_scan["tp"] >= 3
