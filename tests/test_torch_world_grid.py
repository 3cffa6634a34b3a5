"""The one world of the full accuracy grid (18 cells × seeds 7–10) whose
call set differs between the port's two backends on the card: 4× coverage,
noise 1.2, density 1/500, seed 8.

The kernels with genome tables call 5061 C where the ``scan`` backend calls
5057 C. Run on the CPU through both packages, the JAX package splits the
same way: its ``pallas`` backend (interpret mode, tables) calls what the
port's kernels' plain versions call, and its ``scan`` backend what the port's
``scan`` twin calls. The difference is the kernel backend's semantics (the
tables mask the outer k-1 positions of each read's window), not a fault of
either package.
"""

import nadavca_tpu
import torch

torch.set_num_threads(1)

import torch_worlds as W

sweep = W.load_script("accuracy_sweep")
tsweep = W.load_script("torch_accuracy_sweep")

SEED = 8


def test_kernel_and_scan_call_sets_split_alike_in_both_packages():
    cell = tsweep.Cell(coverage=4, noise=1.2, density=1 / 500)
    jcell = sweep.Cell(coverage=4, noise=1.2, density=1 / 500)
    world = tsweep.prepare(cell, SEED)
    _, scan = tsweep.run_cell(cell, "scan", SEED, world=world)
    _, kernels = tsweep.run_cell(cell, "cuda", SEED, world=world)
    _, jscan = sweep.run_cell(jcell, "scan", SEED)
    _, jpallas = sweep.run_cell(jcell, "pallas", SEED, interpret=True,
                                cfg=nadavca_tpu.AlignConfig(kernel_unroll=1))
    assert scan == jscan, sorted(scan ^ jscan)
    assert kernels == jpallas, sorted(kernels ^ jpallas)
    assert sorted(scan ^ kernels) == [(5057, "C"), (5061, "C")]
