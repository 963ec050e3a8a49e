"""SPMD wire audit: what does the compiled mesh program actually put on the interconnect?

`dryrun_multichip` (and tests/test_parallel.py) prove the 8-device program
computes the same NUMBERS as single-device — but a program that all-gathered
the N-sized latents or the image rows would pass every equality test while
being wire-bound on real hardware. This module inspects the OPTIMIZED HLO of
the fused GPPVAE training step (collectives are inserted by XLA's SPMD
partitioner at compile time, so the post-compile text is the ground truth)
and asserts the structural claim of `parallel/mesh.py`:

    the only inter-device traffic inside an epoch is (a) the R×R Gram +
    R×L projection psums of the GP solve, (b) the DP gradient psum
    (param-sized), and (c) per-minibatch bookkeeping (bs-sized gather
    replication) — nothing N-sized or dataset-pixel-sized crosses the mesh.

Two checks, because magnitude alone cannot separate "N-sized" from
"param-sized" at small audit shapes:

  * byte budget — every collective's per-device payload must fit inside
    max(total-param bytes, bs×pixels, R-term) × slack. Catches a whole-array
    all-gather outright.
  * two-N differential — compile the SAME config at two dataset sizes and
    require the multiset of collective (op, shape) signatures to be
    IDENTICAL. Any operand whose shape scales with N changes signature;
    N only survives in scan trip counts (the HLO body is counted once).
    This is the decisive N-independence proof and needs no thresholds.

History: the first run of this audit (round 5) caught real N-sized traffic —
`encode_all`'s global-row-major chunking padded + reshaped the row-sharded
image array at offsets that never align with the per-device blocks, so XLA
re-laid-out all N×pixels bytes with all-to-alls + collective-permutes every
Phase-A refresh. Fixed by shard-local chunking (models/vae.py
`_encode_all_sharded`); the collective set has been exactly (a)+(b)+(c)
since. See BASELINE.md "round-5 SPMD wire audit" for the measured table.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple

__all__ = [
    "Collective",
    "parse_collectives",
    "audit_lowered",
    "audit_fused_wire",
    "assert_wire_structure",
]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# `%name = SHAPE all-reduce(...)` — SHAPE is `f32[a,b]{layout}` or a tuple
# `(f32[..]{..}, s32[..]{..})`. async variants appear as `-start` (skip the
# paired `-done`, which repeats the payload).
_COLL_RE = re.compile(
    r"=\s*(\((?:[^()]|\([^)]*\))*\)|[a-z0-9]+\[[^\]]*\](?:\{[^}]*\})?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all|"
    r"ragged-all-to-all|collective-broadcast)"
    r"(-start)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


class Collective(NamedTuple):
    op: str          # all-reduce | all-gather | …
    shape: str       # normalized shape signature, layouts stripped
    bytes: int       # per-device payload (sum over tuple members)
    op_name: str     # jax op_name metadata (source attribution)


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue  # token types etc. carry no payload
        elems = 1
        for d in dims.split(","):
            if d:
                elems *= int(d)
        total += elems * _DTYPE_BYTES[dtype]
    return total


def parse_collectives(hlo_text: str) -> list[Collective]:
    """Extract every collective instruction from optimized HLO text.

    Shapes in post-partitioning HLO are PER-DEVICE; each entry's `bytes` is
    that device's payload for one execution of the instruction (collectives
    inside scan/while bodies run once per iteration — the audit reports
    program STRUCTURE, not per-epoch totals)."""
    out = []
    for line in hlo_text.splitlines():
        # async `-done` ops never match (_COLL_RE requires `(` or `-start(`
        # right after the op name); do NOT skip lines by substring — a real
        # collective whose OPERAND is a `%…-done.N` value would be dropped,
        # a false-pass hole (round-5 review)
        m = _COLL_RE.search(line)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        nm = re.search(r'op_name="([^"]*)"', line)
        sig = ",".join(f"{t}[{d}]" for t, d in _SHAPE_RE.findall(shape_str))
        out.append(Collective(
            op=op, shape=sig, bytes=_shape_bytes(shape_str),
            op_name=nm.group(1) if nm else "",
        ))
    return out


def _args_bytes(lowered, index: int) -> int:
    """Total bytes of the `index`-th positional argument of a lowered fn."""
    tree = lowered.args_info[0][index]
    import jax

    total = 0
    for leaf in jax.tree.leaves(tree):
        total += math.prod(leaf.shape) * leaf.dtype.itemsize
    return total


def audit_lowered(lowered) -> dict:
    """Tabulate the collectives of ANY lowered jax program (generic half of
    audit_fused_wire — the serving/fold mesh paths use it with their own
    budgets): {collectives, n_collectives, max_bytes, signature}."""
    colls = parse_collectives(lowered.compile().as_text())
    return {
        "collectives": colls,
        "n_collectives": len(colls),
        "max_bytes": max((c.bytes for c in colls), default=0),
        "signature": sorted((c.op, c.shape) for c in colls),
    }


def audit_fused_wire(dataset, config, mesh, n_epochs: int | None = None) -> dict:
    """Compile the fused GPPVAE training step over `mesh` and tabulate its
    collectives. Returns {collectives, n_collectives, max_bytes, budget,
    budget_parts, signature} — `signature` is the sorted (op, shape) multiset
    used by the two-N differential."""
    from gppvae_tpu.train.train_gppvae import _lower_fused

    lowered = _lower_fused(dataset, config, mesh, n_epochs)
    base = audit_lowered(lowered)
    colls = base["collectives"]

    params_bytes = _args_bytes(lowered, 0)
    bs = config.batch_size
    pixels = math.prod(dataset.image_shape)
    rank = config.obj_feature_dim * (2 * config.view_num_freqs + 1)
    rank *= 1 + len(config.extra_effects)
    r_term = 4 * (rank * (rank + config.zdim + bs) + bs * pixels)
    budget_parts = {
        "params_bytes": params_bytes,
        "bs_pixels_bytes": 4 * bs * pixels,
        "r_term_bytes": r_term,
    }
    budget = 2 * max(budget_parts.values())
    return {
        **base,
        "budget": budget,
        "budget_parts": budget_parts,
    }


def assert_wire_structure(dataset, config, mesh, *, dataset_2=None,
                          n_epochs: int | None = None) -> dict:
    """Assert the mesh program's communication structure and return the
    audit table (for logging / the MULTICHIP artifact).

    * every collective's per-device payload ≤ budget (param/bs/R-sized);
    * with `dataset_2` (same config, DIFFERENT row count): the collective
      signature multiset must be identical — nothing on the wire scales
      with N.
    """
    audit = audit_fused_wire(dataset, config, mesh, n_epochs)
    over = [c for c in audit["collectives"] if c.bytes > audit["budget"]]
    if over:
        rows = "\n".join(
            f"  {c.op} {c.shape} = {c.bytes} B  ({c.op_name})" for c in over
        )
        raise AssertionError(
            f"SPMD wire audit: {len(over)} collective(s) exceed the "
            f"R/param/bs-sized budget of {audit['budget']} B "
            f"(parts: {audit['budget_parts']}) — N-sized or pixel-sized "
            f"data is crossing the mesh:\n{rows}"
        )
    if dataset_2 is not None:
        if len(dataset_2.train_idx) == len(dataset.train_idx):
            raise ValueError(
                "assert_wire_structure: dataset_2 must differ in row count "
                "for the N-differential to mean anything"
            )
        audit2 = audit_fused_wire(dataset_2, config, mesh, n_epochs)
        if audit["signature"] != audit2["signature"]:
            from collections import Counter

            c1 = Counter(audit["signature"])
            c2 = Counter(audit2["signature"])
            # Counter subtraction keeps multiplicity, so a count-only change
            # (same op+shape, different number of occurrences) still prints
            # an actionable diff (round-5 review)
            raise AssertionError(
                "SPMD wire audit: collective signatures CHANGE with the "
                "dataset size — N-sized operands are crossing the mesh.\n"
                f"  extra at N={len(dataset.train_idx)}: "
                f"{sorted((c1 - c2).elements())}\n"
                f"  extra at N={len(dataset_2.train_idx)}: "
                f"{sorted((c2 - c1).elements())}"
            )
        audit["n_differential"] = [
            int(len(dataset.train_idx)), int(len(dataset_2.train_idx))
        ]
    return audit
