"""Serialization of `jax.export.Exported` serving programs without flatbuffers.

`Exported.serialize()` needs the optional `flatbuffers` package, which a
deployment machine may lack. The serving artifact needs only what an
unsharded, effect-free export carries: the StableHLO module bytes, the
input/output pytree structures and abstract values (symbolic dims kept as
their strings, e.g. "b"), the lowering platforms and the calling-convention
fields. This module stores those as one JSON header followed by the module
bytes, and rebuilds the `Exported` from them — the same fields, in the same
way, as `jax._src.export.serialization` does for its flatbuffer.

Layout: MAGIC, an 8-byte little-endian header length, the UTF-8 JSON
header, then the serialized module.
"""

from __future__ import annotations

import base64
import json
import struct
import types

import numpy as np
from jax import export as jexport
from jax import tree_util
from jax._src import core
from jax._src.export import _export
from jax._src.export import shape_poly

MAGIC = b"GPPVAE-EXPORT\x00"
VERSION = 1


def _tree_to_json(p) -> dict:
    node_data = p.node_data()
    children = [_tree_to_json(c) for c in p.children()]
    if node_data is None:
        return {"k": "leaf"}
    node_type, aux = node_data
    if node_type is types.NoneType:
        return {"k": "none"}
    if node_type in (tuple, list):
        return {"k": node_type.__name__, "c": children}
    if node_type is dict:
        if not all(isinstance(k, str) for k in aux):
            raise TypeError(f"only str dict keys serialize, got {list(aux)}")
        return {"k": "dict", "keys": list(aux), "c": children}
    if node_type in _export.serialization_registry:
        name, ser_aux = _export.serialization_registry[node_type]
        return {"k": "custom", "name": name, "c": children,
                "aux": base64.b64encode(ser_aux(aux)).decode("ascii")}
    raise ValueError(
        f"cannot serialize a pytree node of unregistered type {node_type}; "
        "use jax.export.register_namedtuple_serialization"
    )


def _tree_from_json(d):
    """A pytree with 0.0 leaves whose structure is the serialized one."""
    kind = d["k"]
    children = [_tree_from_json(c) for c in d.get("c", ())]
    if kind == "leaf":
        return 0.0
    if kind == "none":
        return None
    if kind == "tuple":
        return tuple(children)
    if kind == "list":
        return list(children)
    if kind == "dict":
        return dict(zip(d["keys"], children))
    if kind == "custom":
        if d["name"] not in _export.deserialization_registry:
            raise ValueError(
                f"cannot deserialize unregistered pytree node {d['name']!r}"
            )
        _, de_aux, from_iter = _export.deserialization_registry[d["name"]]
        return from_iter(de_aux(base64.b64decode(d["aux"])), children)
    raise ValueError(f"unknown pytree node kind {kind!r}")


def _aval_to_json(a) -> dict:
    if a.memory_space != core.MemorySpace.Device:
        raise ValueError(f"only device-memory values serialize, got {a}")
    return {"shape": [str(d) for d in a.shape], "dtype": np.dtype(a.dtype).name}


def serialize(exp) -> bytes:
    """Bytes of an unsharded, effect-free `Exported` (see module doc)."""
    shardings = (*exp._in_named_shardings, *exp._out_named_shardings,
                 *exp.in_shardings_hlo, *exp.out_shardings_hlo)
    if exp.nr_devices != 1 or any(s is not None for s in shardings):
        raise ValueError("only single-device, unsharded exports serialize")
    if exp.ordered_effects or exp.unordered_effects:
        raise ValueError("exports with effects do not serialize")
    if exp.disabled_safety_checks:
        raise ValueError("exports with disabled safety checks do not serialize")
    header = {
        "version": VERSION,
        "fun_name": exp.fun_name,
        "in_tree": _tree_to_json(exp.in_tree),
        "out_tree": _tree_to_json(exp.out_tree),
        "in_avals": [_aval_to_json(a) for a in exp.in_avals],
        "out_avals": [_aval_to_json(a) for a in exp.out_avals],
        "platforms": list(exp.platforms),
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": bool(exp.uses_global_constants),
    }
    head = json.dumps(header).encode("utf-8")
    return (MAGIC + struct.pack("<Q", len(head)) + head
            + bytes(exp.mlir_module_serialized))


def deserialize(blob: bytes):
    """The `Exported` that `serialize` wrote; `.call(...)` runs it."""
    if not blob.startswith(MAGIC):
        raise ValueError(
            "not a serving-program blob of this format (it was probably "
            "written by jax.export.serialize in an older build); re-export "
            "it with serve --state … --export_exe"
        )
    pos = len(MAGIC)
    (n,) = struct.unpack("<Q", blob[pos:pos + 8])
    header = json.loads(blob[pos + 8:pos + 8 + n].decode("utf-8"))
    if header.get("version") != VERSION:
        raise ValueError(f"serving-program blob version "
                         f"{header.get('version')!r}; this build reads "
                         f"{VERSION}")
    module = bytes(blob[pos + 8 + n:])
    scope = shape_poly.SymbolicScope(())

    def avals(items):
        return tuple(
            core.ShapedArray(
                jexport.symbolic_shape(",".join(a["shape"]), scope=scope),
                np.dtype(a["dtype"]))
            for a in items)

    in_avals, out_avals = avals(header["in_avals"]), avals(header["out_avals"])
    none_in, none_out = (None,) * len(in_avals), (None,) * len(out_avals)
    return _export.Exported(
        fun_name=header["fun_name"],
        in_tree=tree_util.tree_structure(_tree_from_json(header["in_tree"])),
        in_avals=in_avals,
        out_tree=tree_util.tree_structure(_tree_from_json(header["out_tree"])),
        out_avals=out_avals,
        nr_devices=1,
        in_shardings_hlo=none_in,
        out_shardings_hlo=none_out,
        _has_named_shardings=True,
        _in_named_shardings=none_in,
        _out_named_shardings=none_out,
        platforms=tuple(header["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=module,
        calling_convention_version=header["calling_convention_version"],
        module_kept_var_idx=tuple(header["module_kept_var_idx"]),
        uses_global_constants=header["uses_global_constants"],
        _get_vjp=None,
    )
