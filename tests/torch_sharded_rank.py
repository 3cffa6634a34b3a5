"""One rank of ``tests/test_torch_sharded_group.py``, run as a script:

    python tests/torch_sharded_rank.py JOB OUT PORT RANK WORLD N_LOCAL

It imports only the port. It joins a gloo group of WORLD ranks at
``127.0.0.1:PORT``, takes its rows of the job's batch (rank r: rows
``r·R/WORLD ..``), splits them over N_LOCAL CPU positions and runs
``parallel.sharded`` in every layout of the job, from zeros and from the
job's restored state. It pickles, per run, its rows' score and path and the
merged accumulators, whole, to OUT. Each block is aligned once and its
outputs reused across the runs: the runs differ only in how the blocks'
contributions are summed.
"""

import pickle
import sys

import torch

torch.set_num_threads(1)

from nadavca_tpu_torch import convert, pipeline
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.parallel import distributed as dist
from nadavca_tpu_torch.parallel import sharded


def _align_once():
    memo = {}
    orig = pipeline.align_batch

    def once(batch, model, cfg, **kw):
        key = id(kw["staged"])
        if key not in memo:
            memo[key] = (kw["staged"], orig(batch, model, cfg, **kw))
        return memo[key][1]

    pipeline.align_batch = once


def main(job_path, out_path, port, rank, world, n_local):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.initialize_distributed(f"127.0.0.1:{port}", world, rank, "cpu", n_local)
    try:
        mesh = sharded.process_mesh([torch.device("cpu")] * n_local)
        assert (mesh.size, mesh.first) == (world * n_local, rank * n_local)
        cfg = AlignConfig(read_tile=8)
        model = convert.kmer_model_from_numpy(*job["model"])
        batch = convert.batch_from_numpy(dict(job["batch"]))
        r = batch.x.shape[0] // world
        blocks = sharded.shard_batch(mesh, pipeline.batch_rows(batch, rank * r, (rank + 1) * r),
                                     model, cfg, "scan")
        _align_once()
        G = job["G"]
        out = {}
        for name, gs, md, n_batches, state in job["runs"]:
            step = sharded.make_sharded_step(mesh, cfg, G, gs, merge_deferred=md)
            accs = sharded.make_accumulators_sharded(mesh, G, gs, md, state=state)
            for _ in range(n_batches):
                score, path, *accs = step(blocks, *accs)
            if md:
                merge = sharded.make_merge_fn(mesh, G, gs)
                m1, m2 = merge(*accs), merge(*accs)
                assert all(torch.equal(x, y) for a, b in zip(m1, m2) for x, y in zip(a, b))
                accs = m1
            out[name] = (score.numpy(), path.numpy()) + tuple(
                sharded.fetch(mesh, a, gs) for a in accs)
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], a[1], int(a[2]), int(a[3]), int(a[4]), int(a[5]))
