"""The check that decides ``correct`` under a 9-mer model, at a tiny size on
the CPU: the tiny cell of ``conftest.py`` with ``k`` 9 (the pore model's too)
and a mean dwell of 12.5 samples a base written into its copies. A sound run
is correct; the control (the reference in bfloat16 in the program's place)
is not."""

import json
import os

import pytest
import torch

from conftest import TINY_CELL, make_tiny_root
from h100_bench import cell, control

SEED = 2 ** 33 + 917


@pytest.fixture(scope="module")
def root9(tmp_path_factory):
    root = make_tiny_root(str(tmp_path_factory.mktemp("tiny_checkout_k9")))
    conf_path = os.path.join(root, "h100_bench", "configs", "tiny.json")
    with open(conf_path) as f:
        conf = json.load(f)
    conf["align"]["k"] = 9
    conf["pore_model"]["k"] = 9
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    traffic_path = os.path.join(root, "h100_bench", "traffic", "tinyreads.json")
    with open(traffic_path) as f:
        traffic = json.load(f)
    traffic["mean_dwell"] = 12.5
    with open(traffic_path, "w") as f:
        json.dump(traffic, f)
    return root


def test_a_sound_run_at_k9_is_correct(root9):
    torch.set_num_threads(2)
    res = cell.run(TINY_CELL, SEED, 0.5, False, device="cpu", root=root9)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 32
    # the sampled reads' log-likelihoods were compared, not only zeros
    assert res["checks"]["ll_off_share"]["value"] <= res["checks"]["ll_off_share"]["limit"]


def test_the_control_at_k9_fails(root9):
    nums = control.control_numbers(TINY_CELL, SEED, root9)
    with open(os.path.join(root9, "h100_bench", "limits", TINY_CELL + ".json")) as f:
        lim = json.load(f)
    assert any(nums[k] > lim[k] for k in nums), nums
