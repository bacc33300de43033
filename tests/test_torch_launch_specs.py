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
of the same shape) for three cells.  Every family's prefill and decode
cells count one rank's collectives on the production mesh (dense, moe and
mamba counted exactly at the smoke size); hymba-1.5b's decode cell puts
its state's head dim over 'model' (its 50 heads do not divide 16), as the
reference's ``cache_specs``.
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
    counted = 0
    for r in ok:
        assert r["devices"] == (512 if r["mesh"] == "multi" else 256)
        assert r["memory"]["argument_size_in_bytes"] > 0 and isinstance(r["fits"], bool)
        for key in ("temp_size_in_bytes", "bytes_accessed_per_device", "hlo_bytes", "compile_s"):
            value = r["memory"][key] if key == "temp_size_in_bytes" else r[key]
            assert value is None and r["not_applicable"][key]
        # every family's serving cells run on the model axis: their collectives counted
        if r["kind"] != "train":
            counted += 1
            assert "collectives" not in r["not_applicable"] and r["collective_count"] > 0
            assert r["collective_count"] == sum(v["count"] for v in r["collectives"].values())
            assert r["collective_operand_bytes"] > 0
        else:
            assert r["collectives"] is None and r["collective_count"] is None
            assert r["not_applicable"]["collectives"]
    assert counted == 44  # 10 archs' prefill and decode, 2 long_500k, on both meshes
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


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dry_run_counts_a_dense_cells_collectives_at_the_smoke_size(kind):
    """llama3.2-3b's smoke variant (2 layers, d_model 64, bfloat16) on the
    production mesh: the embedding and each layer's attention output and
    MLP are one all-reduce each of rank 0's rows of the residual stream
    (32 rows over 16 data ranks); the multi-pod mesh halves the rows."""
    from repro_torch.config import ShapeConfig, ShardingPolicy, get_arch, smoke_variant
    from repro_torch.launch.mesh import make_production_mesh

    cfg = smoke_variant(get_arch("llama3.2-3b"))
    seq = 64
    shape = ShapeConfig(kind, seq, 32, kind)
    rows_tokens = 2 * (seq if kind == "prefill" else 1)  # 32 rows over 16 data ranks
    with dryrun.fake_world(512):
        got = {}
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            got[multi] = dryrun.step_collectives(mesh, cfg, shape, ShardingPolicy())
    ar = got[False]["collectives"]["c10d_functional.all_reduce"]
    assert ar["count"] == 2 * cfg.num_layers + 1
    assert ar["bytes"] == ar["count"] * rows_tokens * cfg.d_model * 2
    assert got[False]["collective_count"] == sum(v["count"] for v in
                                                 got[False]["collectives"].values())
    assert got[True]["collectives"]["c10d_functional.all_reduce"]["bytes"] == ar["bytes"] // 2


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dry_run_counts_a_moe_cells_collectives_at_the_smoke_size(kind):
    """deepseek-v2-lite-16b's smoke variant with 16 heads and 32 experts
    (MLA's heads over the 16 model ranks; top-2, a shared expert; 32 experts
    so that the 16 and 32 batch ranks divide them: expert parallelism, 2 or
    1 a rank) on the production mesh: the embedding, then each layer's MLA
    output and MoE output (the routed and shared experts' partial sums
    together) are an all-reduce each over 'model', and its routing
    statistics and slot counts one each over the batch axes ('data'; 'pod'
    and 'data' as one group on the multi-pod mesh).  The slots go to their
    experts' ranks and back by all-to-all, one each way over that group,
    bfloat16, with variable splits.  The dry run has no data, so it splits
    as the balanced routing would: each rank's N k slots spread evenly over
    the experts (the first N k mod E one more), kept up to C.  Prefill on
    the single pod: rank 0's 2 rows of 64 tokens, N = 128, 8 slots an
    expert from each of the 16 ranks, C = round(1.25 x 2,048 x 2 / 32) =
    160, all kept; rank 0 sends its 256 slots and gets 16 x 8 for each of
    its 2 experts, 256.  On the multi-pod mesh 1 row, N = 64: 4 slots an
    expert from each of 32 ranks, C = 160, 128 each way.  Decode: N = 2 (1
    on two pods), C = round(1.25 x 32 x 2 / 32) = 2 (round half to even):
    the first 4 (2) experts get one slot a rank, ranks 0 and 1 keep theirs;
    rank 0 sends 4 (2) and gets its experts' 2 x 2 (2).  So each way N k
    slots of D."""
    import dataclasses

    from repro_torch.config import ShapeConfig, ShardingPolicy, get_arch, smoke_variant
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dataclasses.replace(smoke_variant(get_arch("deepseek-v2-lite-16b")), num_heads=16)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=32))
    shape = ShapeConfig(kind, 64, 32, kind)
    with dryrun.fake_world(512):
        got = {}
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            got[multi] = dryrun.step_collectives(mesh, cfg, shape, ShardingPolicy())
    L, E, D = cfg.num_layers, cfg.moe.num_experts, cfg.d_model
    for multi in (False, True):
        assert got[multi]["collectives"]["c10d_functional.all_reduce"]["count"] == 4 * L + 1
    tokens = {"prefill": (128, 64), "decode": (2, 1)}[kind]  # N on one pod, on two
    k = cfg.moe.top_k
    for multi in (False, True):
        assert got[multi]["collectives"]["c10d_functional.all_to_all_single"] == {
            "count": 2 * L, "bytes": 2 * L * tokens[multi] * k * D * 2}
    if kind == "prefill":
        tokens = 2 * 64
        layer = 2 * tokens * D * 2 + 2 * E * 4 + 16 * E * 8
        assert got[False]["collectives"]["c10d_functional.all_reduce"]["bytes"] == \
            L * layer + tokens * D * 2
    else:  # split-latent decode: the absorbed queries, the rope queries, the partials
        assert got[False]["collectives"]["c10d_functional.all_gather_into_tensor"]["count"] == \
            3 * L


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dry_run_counts_a_mamba_cells_collectives_at_the_smoke_size(kind):
    """mamba2-2.7b's smoke variant (2 layers, d_model 64, d_inner 128, 8 SSM
    heads of 16, bfloat16) on the production mesh: the embedding and each
    layer's gated norm (its float32 sum of squares a row) and output are an
    all-reduce each over 'model'; each layer gathers its conv output [rows,
    tokens, 160] whole and, its 8 heads not dividing 16 ranks, the scan's
    output from its head-dim columns [rows, tokens, 8, 16]."""
    from repro_torch.config import ShapeConfig, ShardingPolicy, get_arch, smoke_variant
    from repro_torch.launch.mesh import make_production_mesh

    cfg = smoke_variant(get_arch("mamba2-2.7b"))
    tokens = 2 * (64 if kind == "prefill" else 1)  # rank 0's 2 rows of 32 over 16
    with dryrun.fake_world(512):
        mesh = make_production_mesh(device_type="cpu")
        got = dryrun.step_collectives(mesh, cfg, ShapeConfig(kind, 64, 32, kind),
                                      ShardingPolicy())["collectives"]
    L, D, d_in = cfg.num_layers, cfg.d_model, 128
    ar, ag = got["c10d_functional.all_reduce"], got["c10d_functional.all_gather_into_tensor"]
    assert ar == {"count": 2 * L + 1, "bytes": tokens * (D * 2 * (L + 1) + 4 * L)}
    assert ag == {"count": 2 * L, "bytes": L * tokens * ((d_in + 32) + d_in) * 2}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dry_run_cuts_padded_logits_without_gathering_them(kind):
    """phi4-mini-3.8b's smoke variant with a vocabulary of 200 in a table of
    256 rows (16 a rank over 16 model ranks; the cut's shards are 13 wide)
    on the production mesh: the logits keep their padded shards, and the
    cut for the caller is one all-to-all in which rank 0 sends its last 3
    columns of its rows' float32 logits; every other collective is the one
    of the same model without pad rows."""
    import dataclasses

    from repro_torch.config import ShapeConfig, ShardingPolicy, get_arch, smoke_variant
    from repro_torch.launch.mesh import make_production_mesh

    cfg = smoke_variant(get_arch("phi4-mini-3.8b"))
    tokens = 2 * (64 if kind == "prefill" else 1)  # rank 0's 2 rows of 32 over 16
    got = {}
    with dryrun.fake_world(512):
        mesh = make_production_mesh(device_type="cpu")
        for vocab in (256, 200):
            got[vocab] = dryrun.step_collectives(
                mesh, dataclasses.replace(cfg, vocab_size=vocab),
                ShapeConfig(kind, 64, 32, kind), ShardingPolicy())["collectives"]
    cut = got[200].pop("c10d_functional.all_to_all_single")
    assert cut == {"count": 1, "bytes": 3 * tokens * 4}
    assert got[200] == got[256]


def test_hymba_decode_cell_shards_its_states_head_dim():
    """hymba-1.5b's 50 SSM heads divide neither the 16 model ranks nor (so)
    its state's placement: the state [L, B, 50, 64, 16] goes over 'model' on
    its head dim (4 columns a rank), the conv window on its 3,232 channels,
    the ring cache of 1,024 entries on its sequence; the cell's collectives
    are counted."""
    with dryrun.fake_world(512):
        mesh = make_production_mesh(device_type="cpu")
        cell = specs.build_cell(mesh, "hymba-1.5b", "decode_32k")
        rec = dryrun.run_cell("hymba-1.5b", "decode_32k", False, verbose=False)
    cache, sh = cell.args[1], cell.in_shardings[1]
    assert tuple(sh["ssm"]["state"].spec) == (None, "data", None, "model", None)
    assert sh["ssm"]["state"].shard_shape(cache["ssm"]["state"].shape) == (32, 8, 50, 4, 16)
    assert sh["ssm"]["conv"].shard_shape(cache["ssm"]["conv"].shape) == (32, 8, 3, 202)
    assert sh["k"].shard_shape(cache["k"].shape) == (32, 8, 64, 5, 64)
    assert rec["status"] == "ok" and rec["collective_count"] > 0
    assert "collectives" not in rec["not_applicable"]
