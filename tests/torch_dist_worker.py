"""One rank of tests/test_torch_distributed.py's multi-process runs.

Started by ``qldpc_tpu_torch.parallel.smoke.launch`` as ``python
tests/torch_dist_worker.py --worker --job DIR --rank r``; it imports only
the port. Beside the job's engine cases (``smoke.run_cases``) it runs, on
the CPU:

- ``checkpoint``: a CheckpointManager run stopped on every rank after
  ``stop_after`` batches and resumed, and the same rate resumed from a
  checkpoint one process wrote (``resume_dir``); it counts this rank's
  saves;
- ``alpha``: Alvarado's alpha, fitted by this rank.
"""

import argparse
import functools
import json
import sys
from pathlib import Path

import torch.distributed as dist

from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders.alvarado import estimate_alpha
from qldpc_tpu_torch.mc import CheckpointManager, counters_to_dict
from qldpc_tpu_torch.parallel import make_mesh
from qldpc_tpu_torch.parallel import smoke


class Interrupted(Exception):
    pass


def checkpoint(job: dict, mesh) -> dict:
    case = {**smoke.CASE_DEFAULTS, **job["checkpoint"]}
    eng = smoke.build_engine(case, "cpu", mesh)
    p, trials, seed, k = case["rates"][0], case["trials"], case["seed"], case["stop_after"]
    saves = []
    run_rate = eng.run_rate

    def stopping(*args, on_batch, **kw):
        def each(b, n_batches, total):
            on_batch(b, n_batches, total)
            if b + 1 == k:
                raise Interrupted

        return run_rate(*args, on_batch=each, **kw)

    class Counting(CheckpointManager):
        def save(self, *args):
            saves.append(args[-1])
            super().save(*args)

    eng.run_rate = stopping
    try:
        Counting(job["ckpt_dir"]).run_rate(eng, p, trials, seed)
        raise AssertionError("the run was not interrupted")
    except Interrupted:
        pass
    dist.barrier()  # the job's restart: process 0's last save is done
    eng.run_rate = run_rate
    stopped_at = CheckpointManager(job["ckpt_dir"]).load(eng, p, seed)[1]
    resumed = Counting(job["ckpt_dir"]).run_rate(eng, p, trials, seed)
    from_one = Counting(job["resume_dir"]).run_rate(eng, p, trials, seed)
    return dict(saves=saves, stopped_at=stopped_at,
                resumed=smoke.jsonable(counters_to_dict(resumed)),
                from_one_process=smoke.jsonable(counters_to_dict(from_one)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--job")
    ap.add_argument("--rank", type=int)
    args = ap.parse_args(argv)
    job = smoke.join(args.job, args.rank)
    try:
        meshes = functools.cache(make_mesh)
        out = dict(cases=smoke.run_cases(job["cases"], "cpu", meshes))
        if "checkpoint" in job:
            out["checkpoint"] = checkpoint(job, meshes(1))
        if "alpha" in job:
            a = job["alpha"]
            out["alpha"] = estimate_alpha(get_code(a["code"]).Hx, a["p"], method=a["method"],
                                          seed=a["seed"], device="cpu")
        Path(args.job, f"rank{args.rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
