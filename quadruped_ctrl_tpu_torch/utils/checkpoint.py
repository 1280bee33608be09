"""Checkpoint / resume for controller + simulator state trees.

The counterpart of `quadruped_ctrl_tpu/utils/checkpoint.py`. The reference
has no state serialization anywhere (reset re-creates the controller); for
long batched sweeps this saves/restores the full (controller, sim) tree as
an .npz of its leaves. The leaves are in `jax.tree.flatten`'s order
(`core/types.tree_flatten`: dataclass fields as declared, dict keys
sorted), so a checkpoint written by either package loads into the other's
tree of the same shape. A `fingerprint` (any JSON-able dict of run
parameters) can be stored alongside the tree; `load` refuses a checkpoint
whose fingerprint does not match, so a sweep cannot silently resume against
different seeds/terrains/configs.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import torch

from quadruped_ctrl_tpu_torch.core.types import tree_flatten, tree_unflatten


def save(path: str, tree, fingerprint: dict | None = None) -> None:
    leaves, _ = tree_flatten(tree)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)}
    if fingerprint is not None:
        arrays["fingerprint"] = np.frombuffer(
            json.dumps(fingerprint, sort_keys=True).encode(), dtype=np.uint8
        )
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(p, n_leaves=len(leaves), **arrays)


def load(path: str, example_tree, fingerprint: dict | None = None):
    """Restore into the structure of `example_tree`, each leaf with the
    dtype and on the device of the example's leaf.

    Raises ValueError on leaf-count or shape mismatch (a stale or foreign
    checkpoint), and on fingerprint mismatch when one is supplied both here
    and in the file.
    """
    with np.load(path) as data:
        if fingerprint is not None and "fingerprint" in data:
            stored = json.loads(bytes(data["fingerprint"]).decode())
            want = json.loads(json.dumps(fingerprint, sort_keys=True))
            if stored != want:
                raise ValueError(
                    f"checkpoint {path} was written by a different run: "
                    f"stored fingerprint {stored} != requested {want}"
                )
        elif fingerprint is not None:
            # legacy checkpoint written before fingerprints existed: it cannot
            # be validated against the requested run parameters. Surface that
            # loudly; a structural mismatch (e.g. a leaf added since) still
            # raises below, and such checkpoints should be discarded.
            warnings.warn(
                f"checkpoint {path} has no stored fingerprint (pre-fingerprint "
                "revision); run-parameter validation skipped — discard it if the "
                "sweep parameters may have changed",
                stacklevel=2,
            )
        n = int(data["n_leaves"])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    example_leaves, spec = tree_flatten(example_tree)
    if len(leaves) != len(example_leaves):
        raise ValueError(
            f"checkpoint {path} has {len(leaves)} leaves, expected "
            f"{len(example_leaves)}"
        )
    for i, (l, e) in enumerate(zip(leaves, example_leaves)):
        if tuple(l.shape) != tuple(e.shape):
            raise ValueError(
                f"checkpoint {path} leaf {i} has shape {tuple(l.shape)}, "
                f"expected {tuple(e.shape)}"
            )
    return tree_unflatten(spec, [torch.as_tensor(l).to(device=e.device, dtype=e.dtype)
                                 for l, e in zip(leaves, example_leaves)])
