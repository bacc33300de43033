"""The port's dry-run cells (``repro_torch.launch.specs``), its production
mesh (``launch/mesh.py``) and its dry run (``launch/dryrun.py``) against the
reference's, on the CPU.

The 40 assigned cells and their 8 skips equal the reference's; every
input's shape and dtype (train, prefill and decode, ten archs) equals the
reference's ``ShapeDtypeStruct`` leaf for leaf (block leaves stacked); the
production meshes build over a fake process group of 256 / 512 ranks and
refuse fewer; the dry run builds all 40 cells on both meshes with no
error, and its per-device argument bytes equal the sum of the reference's
shard shapes (JAX's ``NamedSharding.shard_shape`` on an ``AbstractMesh``
of the same shape) for three cells.
"""

from __future__ import annotations

import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding

from repro.launch import specs as ref_specs
from repro_torch.convert import reference_key
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Transformer
from repro_torch.runtime import TrainState

ARCHS = dryrun.ARCH_ORDER


def test_forty_cells_with_eight_skips_as_the_reference():
    cells = specs.all_cells()
    assert len(cells) == 40
    assert sorted(cells) == sorted(ref_specs.all_cells())
    skips = [(a, s) for a, s, reason in cells if reason]
    assert len(skips) == 8 and all(s == "long_500k" for _, s in skips)
    assert {a for a, s, r in cells if s == "long_500k" and not r} == {"mamba2-2.7b", "hymba-1.5b"}


def _port_leaves(tree, prefix="") -> dict:
    """(shape, dtype) of an input tree's leaves by the reference's path,
    block leaves stacked over their layers."""
    if isinstance(tree, TrainState):
        return _port_leaves({"params": tree.params, "opt": {"step": tree.opt.step,
                                                             "m": tree.opt.m, "v": tree.opt.v}},
                            prefix)
    if isinstance(tree, Transformer):
        tree = dict(tree.named_parameters())
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    out: dict = {}
    layers: dict = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor) and "." in k:  # a parameter name
            key, layer = reference_key(k)
            if layer is not None:
                layers.setdefault(prefix + key, []).append(v)
                continue
            k = key
        out.update(_port_leaves(v, f"{prefix}{k}/"))
    for key, ts in layers.items():
        assert len({(t.shape, t.dtype) for t in ts}) == 1, key
        out[key] = ((len(ts), *ts[0].shape), str(ts[0].dtype).split(".")[-1])
    return out


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            (tuple(leaf.shape), leaf.dtype.name) for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_equal_the_references(arch, shape):
    got = specs.input_specs(arch, shape)
    leaves = [t for t in _flat_tensors(got)]
    assert leaves and all(t.device.type == "meta" for t in leaves)  # no allocation
    assert _port_leaves(got) == _ref_leaves(ref_specs.input_specs(arch, shape))


def _flat_tensors(tree):
    if isinstance(tree, TrainState):
        yield from _flat_tensors({"p": tree.params, "s": tree.opt.step, "m": tree.opt.m,
                                  "v": tree.opt.v})
    elif isinstance(tree, Transformer):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_tensors(v)
    else:
        yield tree


def test_production_meshes_over_a_fake_world():
    with dryrun.fake_world(512):
        single = make_production_mesh(device_type="cpu")
        multi = make_production_mesh(multi_pod=True, device_type="cpu")
        assert (tuple(single.shape), single.mesh_dim_names) == ((16, 16), ("data", "model"))
        assert (tuple(multi.shape), multi.mesh_dim_names) == ((2, 16, 16),
                                                              ("pod", "data", "model"))
        with pytest.raises(RuntimeError, match=r"needs 512 devices, found 300"):
            make_production_mesh(multi_pod=True, devices=range(300), device_type="cpu")
    with dryrun.fake_world(100):
        with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 devices, found 100"):
            make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 256 devices, found 1"):
        make_production_mesh(device_type="cpu")  # no process group: one rank


def test_dry_run_writes_eighty_records_without_an_error(tmp_path):
    assert dryrun.main(["--all", "--mesh", "both", "--out-dir", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 80
    assert not [r for r in recs if r["status"] == "error"]
    assert sum(r["status"] == "skip" for r in recs) == 16
    ok = [r for r in recs if r["status"] == "ok"]
    for r in ok:
        assert r["devices"] == (512 if r["mesh"] == "multi" else 256)
        assert r["memory"]["argument_size_in_bytes"] > 0 and isinstance(r["fits"], bool)
        for key in ("temp_size_in_bytes", "bytes_accessed_per_device", "collectives",
                    "hlo_bytes", "compile_s"):
            value = r["memory"][key] if key == "temp_size_in_bytes" else r[key]
            assert value is None and r["not_applicable"][key]
    with pytest.raises(SystemExit, match="bench_out"):
        dryrun.main(["--all", "--out-dir", "bench_out/dryrun"])


def _ref_argument_bytes(arch, shape, mesh_shape, axes) -> int:
    mesh = AbstractMesh(mesh_shape, axes)
    cell = ref_specs.build_cell(mesh, arch, shape)
    total = 0
    for arg, sh in zip(cell.args, cell.in_shardings):
        leaves = jax.tree.leaves(arg)
        shards = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, RefNamedSharding))
        assert len(leaves) == len(shards)
        total += sum(math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
                     for l, s in zip(leaves, shards))
    return total


@pytest.mark.parametrize("arch,shape,multi", [("llama3.2-3b", "train_4k", False),
                                              ("minitron-8b", "prefill_32k", False),
                                              ("mamba2-2.7b", "decode_32k", True)])
def test_argument_bytes_equal_the_references_shard_shapes(arch, shape, multi):
    with dryrun.fake_world(512):
        rec = dryrun.run_cell(arch, shape, multi, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    mesh_shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else \
        ((16, 16), ("data", "model"))
    assert rec["memory"]["argument_size_in_bytes"] == _ref_argument_bytes(arch, shape,
                                                                         mesh_shape, axes)
