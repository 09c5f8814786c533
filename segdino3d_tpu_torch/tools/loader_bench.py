"""The training loader's stages for one batch of the flagship config.

    python -m segdino3d_tpu_torch.tools.loader_bench [--reps N]

Writes ``chip_smoke.py`` phase 4d's four headline scenes (120,000 points,
1,536 superpoints, 256-d DINO-X features) to a temp dir, builds the
flagship prototype's train reader from its config node (roots pointed at
them) and times, in this process, what a process-mode worker and the
consumer do for one batch 4 of ``accum_steps`` 4 (the CLI's loader): the
records (read, train augmentations, sync scale), the collate of each
microbatch to the config's capacities, the block-dense host plans, the
worker's numpy conversion and shared-memory encode, and the consumer's
decode and copy to the card (synchronised).  Prints each repetition's
seconds per stage and the batch's bytes, beside the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("loader_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.builder import Capacities, host_plan_args
    from segdino3d_tpu_torch.config.config import Config
    from segdino3d_tpu_torch.data import shm_transport as TS
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate, map_leaves,
                                                  to_device)
    from segdino3d_tpu_torch.data.loader import _to_numpy, _to_torch
    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout
    from segdino3d_tpu_torch.registry import DATASETS
    import segdino3d_tpu_torch.data.scannet_dataset  # noqa: F401

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = Config.fromfile(os.path.join(
        os.path.dirname(os.path.abspath(C.__file__)), "configs",
        "prototypes", "SegDINO3D_ScanNet200.py"))
    caps = Capacities.from_cfg(cfg.capacities)
    spec = PadSpec(caps.num_points, caps.num_superpoints,
                   caps.num_instances, caps.num_queries2d,
                   cfg.model["decoder_cfg"]["num_semantic_classes"])
    plan = dict(host_plan_args(cfg.model, train=True),
                voxel_cap=caps.num_voxels)
    with tempfile.TemporaryDirectory() as root:
        write_scannet_layout(root, C.CLI_SEEDS, **C.SCENE)
        node = dict(cfg.data["train_main"][0], root_scenes=root,
                    root_points_2dfeats=os.path.join(root, "features_2d"))
        ds = DATASETS.build(node)
        for rep in range(args.reps):
            t = [time.perf_counter()]
            recs = [ds.get_record(i, np.random.RandomState(100 * rep + i),
                                  sync_scale=1.0)
                    for i in range(len(C.CLI_SEEDS))]
            t.append(time.perf_counter())
            mbs = [collate([r], spec, "cpu") for r in recs]
            t.append(time.perf_counter())
            mbs = [attach_host_plan(b, [r], spec, **plan)
                   for b, r in zip(mbs, recs)]
            t.append(time.perf_counter())
            item = TS.encode(_to_numpy(mbs))
            t.append(time.perf_counter())
            host, shm = TS.decode(item)
            on_card = to_device(_to_torch(host), "cuda")
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            nbytes = []
            map_leaves(host, lambda x: nbytes.append(x.nbytes)
                       if isinstance(x, np.ndarray) else None)
            print(f"rep {rep}: records {t[1] - t[0]:.3f} s, collate "
                  f"{t[2] - t[1]:.3f}, host plans {t[3] - t[2]:.3f}, numpy "
                  f"+ shm encode {t[4] - t[3]:.3f}, decode + copy to the "
                  f"card {t[5] - t[4]:.3f}; {sum(nbytes) / 2 ** 30:.3f} GiB "
                  f"a batch of {len(recs)} microbatches", flush=True)
            del on_card, host
            if shm is not None:
                shm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
