"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
reference's (``repro.runtime.sharding``), on the CPU.

The reference keys its rules on a leaf's rank in its layer-stacked tree;
the port keeps a module a layer.  So every leaf of all ten registered
archs (shapes only: ``param_shapes`` on both sides, the port's on the meta
device) is held leaf for leaf: the port's spec equals the reference's with
the layer's entry dropped, under the default policy, with
``fsdp_params=False`` and with the expert axes flipped.  The batch and
cache specs are compared directly, and the DTensor shard shapes of the
smoke archs' leaves on a (2, 2, 2) mesh (a fake process group of 8 ranks
in this process) against JAX's ``NamedSharding.shard_shape`` on an
``AbstractMesh`` of the same shape.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as RefP

from repro.config import ShardingPolicy as RefPolicy
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.models import param_shapes as ref_param_shapes
from repro.runtime import sharding as ref_sharding
from repro_torch.config import ShardingPolicy, get_arch, smoke_variant
from repro_torch.convert import reference_key
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import param_shapes
from repro_torch.models.layers import PartitionSpec as P
from repro_torch.models.layers import activate_mesh, constrain, current_mesh, fix_spec
from repro_torch.runtime import sharding

ARCHS = ["phi4-mini-3.8b", "llama3.2-3b", "mistral-large-123b", "minitron-8b",
         "paligemma-3b", "mamba2-2.7b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
         "hymba-1.5b", "musicgen-medium"]
POLICIES = {"default": {}, "fsdp_off": {"fsdp_params": False},
            "experts_flipped": {"expert_axis": "model", "expert_ff_axis": "data"}}


@pytest.fixture(scope="module")
def ref_shapes():
    """The reference's parameter shape trees (bfloat16), by arch."""
    return {a: ref_param_shapes(ref_get_arch(a)) for a in ARCHS}


def _ref_flat(tree) -> dict:
    """A reference tree's leaves by ``/``-joined path."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _port_by_key(named: dict) -> dict:
    """The port's per-layer values by reference key: a block leaf's value
    must be the same on every layer."""
    out: dict = {}
    for name, v in named.items():
        key, _ = reference_key(name)
        if key in out:
            assert out[key] == v, (name, out[key], v)
        out[key] = v
    return out


def _stacked(key: str) -> bool:
    return key.startswith("blocks/")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_the_references_leaf_for_leaf(arch, ref_shapes):
    cfg = get_arch(arch)
    model = param_shapes(cfg)
    named = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in named.values())  # nothing allocated
    ref = _ref_flat(ref_shapes[arch])
    got = _port_by_key({n: (tuple(p.shape), str(p.dtype).split(".")[-1])
                        for n, p in named.items()})
    assert set(got) == set(ref)
    for key, leaf in ref.items():
        shape = tuple(leaf.shape[1:]) if _stacked(key) else tuple(leaf.shape)
        assert got[key] == (shape, leaf.dtype.name), key
    layers = {reference_key(n)[1] for n in named} - {None}
    assert layers == set(range(cfg.num_layers))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references_with_the_layer_dim_dropped(arch, policy, ref_shapes):
    kw = POLICIES[policy]
    want = _ref_flat(ref_sharding.param_specs(ref_shapes[arch], RefPolicy(**kw)))
    got = _port_by_key(sharding.param_specs(param_shapes(get_arch(arch)), ShardingPolicy(**kw)))
    assert set(got) == set(want)
    for key, spec in want.items():
        assert isinstance(got[key], P)
        assert tuple(got[key]) == (tuple(spec)[1:] if _stacked(key) else tuple(spec)), key


@pytest.mark.parametrize("arch", ["llama3.2-3b", "paligemma-3b", "musicgen-medium",
                                  "mamba2-2.7b"])
@pytest.mark.parametrize("batch_size", [None, 1, 8])
def test_batch_specs_equal_the_references(arch, batch_size):
    want = ref_sharding.batch_specs(ref_get_arch(arch), None, batch_size=batch_size)
    got = sharding.batch_specs(get_arch(arch), None, batch_size=batch_size)
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    if batch_size == 1:
        assert got["tokens"][0] is None  # a single stream cannot shard its batch


@pytest.mark.parametrize("arch,kv", [("llama3.2-3b", "bf16"), ("llama3.2-3b", "int8"),
                                     ("deepseek-v2-lite-16b", "bf16"), ("mamba2-2.7b", "bf16"),
                                     ("hymba-1.5b", "bf16"), ("hymba-1.5b", "int8")])
@pytest.mark.parametrize("batch_size,divisor", [(128, None), (128, 16), (1, 16), (1, None)])
def test_cache_specs_equal_the_references_with_the_divisor_fallback(arch, kv, batch_size,
                                                                     divisor):
    want = _ref_flat(ref_sharding.cache_specs(ref_get_arch(arch), RefPolicy(kv_cache_dtype=kv),
                                              batch_size=batch_size, model_divisor=divisor))
    got = sharding.cache_specs(get_arch(arch), ShardingPolicy(kv_cache_dtype=kv),
                               batch_size=batch_size, model_divisor=divisor)
    flat = {}
    for k, v in got.items():
        flat.update({f"{k}/{kk}": vv for kk, vv in v.items()} if isinstance(v, dict) else {k: v})
    assert {k: tuple(v) for k, v in flat.items()} == {k: tuple(v) for k, v in want.items()}
    if arch == "hymba-1.5b" and divisor == 16:  # 50 heads: head_dim sharded instead
        assert flat["ssm/state"][2] is None and flat["ssm/state"][3] == "model"


def test_fix_spec_and_placements_follow_the_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"))
        single = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        spec = P(("pod", "data"), "model")
        assert sharding.placements(mesh, spec) == (Shard(0), Shard(0), Shard(1))
        assert fix_spec(single, spec) == P("data", "model")  # no pod on a single pod
        assert sharding.placements(single, spec) == (Shard(0), Shard(1))
        assert sharding.placements(single, P()) == (Replicate(), Replicate())
        with pytest.raises(ValueError, match="shards two dims"):
            sharding.placements(mesh, P("model", "model"))
        with pytest.raises(ValueError, match="out of the mesh's order"):
            sharding.placements(mesh, P(("data", "pod")))


def test_activate_mesh_nests_and_constrain_is_the_identity():
    outer, inner = object(), object()
    x = torch.ones(2, 3)
    assert current_mesh() is None
    with activate_mesh(outer):
        with activate_mesh(inner):
            assert current_mesh() is inner
            assert constrain(x, ("pod", "data"), None, "model") is x
        assert current_mesh() is outer
    assert current_mesh() is None


SMOKE = ["llama3.2-3b", "mamba2-2.7b", "hymba-1.5b", "deepseek-v2-lite-16b", "musicgen-medium",
         "paligemma-3b"]


def test_shard_shapes_equal_jax_named_sharding_on_a_small_mesh():
    """Every leaf of six smoke archs on a (pod 2, data 2, model 2) mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    axes = ("pod", "data", "model")
    ref_mesh = AbstractMesh((2, 2, 2), axes)
    n = 0
    with fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2), mesh_dim_names=axes)
        for arch in SMOKE:
            ref_cfg = ref_smoke_variant(ref_get_arch(arch))
            shapes = ref_param_shapes(ref_cfg)
            want_specs = _ref_flat(ref_sharding.param_specs(shapes, RefPolicy()))
            ref = _ref_flat(shapes)
            model = param_shapes(smoke_variant(get_arch(arch)))
            got = sharding.shardings_for(mesh, None, ShardingPolicy(), model)
            by_key = _port_by_key({name: got[name].shard_shape(p.shape)
                                   for name, p in model.named_parameters()})
            for key, leaf in ref.items():
                want = RefNamedSharding(ref_mesh, want_specs[key]).shard_shape(leaf.shape)
                assert by_key[key] == (want[1:] if _stacked(key) else want), (arch, key)
                n += 1
    assert n == 87


def test_shard_model_refuses_a_model_axis_wider_than_one():
    """Under a policy value whose model-axis layout is not ported (every
    family's default layout is: tests/test_torch_tensor_parallel*.py; the
    int8 cache and the experts over 'model' are too, and beside a model
    axis named other than 'model' that one alone is refused)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.config import ShardingPolicy
    from repro_torch.models import init_params

    model = init_params(smoke_variant(get_arch("mamba2-2.7b")), seed=0, dtype=torch.float32,
                        device="cpu")
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        sharding.check_model_axis(smoke_variant(get_arch("mamba2-2.7b")),
                                  ShardingPolicy(kv_cache_dtype="int8"), 2, 2)  # runs now
        with pytest.raises(ValueError,
                           match=r"\{'model_axis': 'tp'\} .*model axis wider than 1 .*A\.18"):
            sharding.shard_model(model, mesh, ShardingPolicy(kv_cache_dtype="int8",
                                                             model_axis="tp"))
        moe = smoke_variant(get_arch("deepseek-v2-lite-16b"))
        pair = {"expert_axis": "model", "expert_ff_axis": "data"}
        sharding.check_model_axis(moe, ShardingPolicy(**pair), 2, 2)  # runs now (A.18 item 7)
        with pytest.raises(ValueError, match=r"\{'model_axis': 'tp'\} .*A\.18") as err:
            sharding.tp_distribute(param_shapes(moe), mesh, ShardingPolicy(**pair,
                                                                           model_axis="tp"))
        assert "expert" not in str(err.value)
        pod = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("pod", "data"))
        with pytest.raises(ValueError, match="FSDP runs over"):
            sharding.shard_model(model, pod)
    assert not sharding.is_sharded(model)


def test_sharded_leaves_follow_the_data_entry_of_their_spec():
    """On a (data, model=1) mesh FSDP splits each weight on the dim its
    spec puts over 'data' (embed [V, D] on D, experts on E) and keeps the
    leaves without a data entry whole."""
    specs = sharding.param_specs(param_shapes(smoke_variant(get_arch("deepseek-v2-lite-16b"))))
    dims = {n: sharding._data_dim(s) for n, s in specs.items()}
    assert dims["embed"] == 1 and dims["head"] == 0
    assert dims["blocks.0.moe.w_gate"] == 0 and dims["blocks.0.moe.router"] == 0
    assert dims["blocks.0.attn.w_o"] == 1 and dims["blocks.0.attn.w_uk"] is None
    assert dims["blocks.0.ln1"] is None and dims["ln_f"] is None
    ssm = sharding.param_specs(param_shapes(smoke_variant(get_arch("mamba2-2.7b"))))
    whole = sorted({reference_key(n)[0] for n, s in ssm.items() if sharding._data_dim(s) is None})
    assert whole == ["blocks/ln1", "blocks/mamba/A_log", "blocks/mamba/D", "blocks/mamba/conv_w",
                     "blocks/mamba/dt_bias", "blocks/mamba/norm_w", "ln_f"]
    assert np.all([isinstance(s, P) for s in ssm.values()])
