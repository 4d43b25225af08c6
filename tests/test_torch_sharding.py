"""The port's logical-axis sharding rules against the JAX package's.

``repro_torch.distributed.MeshRules`` resolves the same tokens to the
same ``PartitionSpec`` parts, with the same divisibility fallbacks, as
``repro.distributed.MeshRules`` on a ``jax.sharding.AbstractMesh`` of the
same shape (no device needed on either side); the DTensor placements it
makes give every rank the slice that ``NamedSharding(...)
.devices_indices_map`` gives the JAX device at the same mesh coordinate
(eight forced CPU devices, in one subprocess); and ``kv_cache_heads`` and
``cache_shardings`` agree with the JAX package's at model-axis sizes 1,
2, 4 and 16.
"""

import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

from repro import configs as jconfigs
from repro.distributed import MeshRules as JaxRules
from repro.distributed import use_rules as jax_use_rules
from repro.models import param_specs as jax_param_specs
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.distributed import MeshRules, use_rules
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOKENS = (None, "batch", "fsdp", "model", "seq")
MESHES = {  # name: (shape, mesh dim names)
    "test2x4": ((2, 4), ("data", "model")),
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
OPTIONS = [dict(), dict(fsdp_over_pod=True), dict(seq_shard=True), dict(fsdp=False)]


class _Mesh:
    """What ``MeshRules`` reads of a ``DeviceMesh``: dim names and sizes
    (so the rules are compared without a process group)."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, i):
        return self.shape[i]


def _parts(p):
    return tuple(p)


def _leaf_shapes(cfg_name):
    out = []
    for get in (configs.get_smoke, configs.get):
        out += [s for s in tree_leaves(tf.param_specs(get(cfg_name)))]
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_spec_and_fallbacks_match_the_jax_rules(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    for opts in OPTIONS:
        ours = MeshRules(_Mesh(shape, names), **opts)
        ref = JaxRules(AbstractMesh(shape, names), **opts)
        for spec in _leaf_shapes(arch):
            cases = [spec.axes] + [
                tuple(t if j == i else None for j in range(len(spec.shape)))
                for t in TOKENS for i in (0, len(spec.shape) - 1)]
            for tokens in cases:
                assert ours.partition(tokens, spec.shape) == _parts(ref.spec(tokens, spec.shape)), \
                    (opts, tokens, spec.shape)
        assert ours.fallbacks == ref.fallbacks
        for tok in TOKENS:
            assert ours.axes_for(tok) == ref.axes_for(tok)


def test_param_specs_carry_the_jax_axes():
    for name in configs.ARCHS:
        for get, jget in ((configs.get, jconfigs.get), (configs.get_smoke, jconfigs.get_smoke)):
            ours = tree_leaves(tf.param_specs(get(name)))
            theirs = [s for s in jax_leaves(jax_param_specs(jget(name)))]
            assert [(s.shape, s.axes, s.init, s.fan_in_axis) for s in ours] == \
                [(s.shape, s.axes, s.init, s.fan_in_axis) for s in theirs], name


def jax_leaves(specs):
    import jax

    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax_tf.PSpec))


# --- each rank's slice against devices_indices_map --------------------------
SLICE_CASES = {
    "2x4": ((2, 4), ("data", "model"), [
        ((8, 12, 16), ("batch", "model", None)),
        ((8, 12, 16), (None, "fsdp", "model")),
        ((6, 8), ("batch", "model")),
        ((16, 4), ("fsdp", None)),
    ]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), [
        ((8, 12, 16), ("batch", "model", None)),  # batch on ("pod", "data")
        ((8, 12), ("batch", "model")),
        ((4, 8), ("model", "batch")),
        ((2, 8), ("batch", "model")),  # batch 2 on ("pod", "data"): falls back to ("data",)
        ((16, 4, 6), ("fsdp", None, "model")),
    ]),
}

JAX_SLICES = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import _make_auto_mesh
cases = json.loads(sys.argv[1])
out = {}
for name, (mshape, names, items) in cases.items():
    mesh = _make_auto_mesh(tuple(mshape), tuple(names))
    res = []
    for shape, parts in items:
        parts = [tuple(p) if isinstance(p, list) else p for p in parts]
        imap = NamedSharding(mesh, P(*parts)).devices_indices_map(tuple(shape))
        per = {}
        for idx in np.ndindex(mesh.devices.shape):
            sl = imap[mesh.devices[idx]]
            per[",".join(map(str, idx))] = [[s.start or 0, s.stop if s.stop is not None else n]
                                            for s, n in zip(sl, shape)]
        res.append(per)
    out[name] = res
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_slices():
    cases = {}
    for name, (mshape, names, items) in SLICE_CASES.items():
        rules = MeshRules(_Mesh(mshape, names))
        cases[name] = [mshape, names, [[shape, list(rules.partition(tokens, shape))]
                                       for shape, tokens in items]]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_SLICES, json.dumps(cases)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_name", sorted(SLICE_CASES))
def test_each_rank_slice_matches_devices_indices_map(jax_slices, mesh_name):
    mshape, names, items = SLICE_CASES[mesh_name]
    rules = MeshRules(_Mesh(mshape, names))
    for (shape, tokens), per in zip(items, jax_slices[mesh_name]):
        placements = rules.spec(tokens, shape)
        for coord in itertools.product(*(range(n) for n in mshape)):
            local, offset = _compute_local_shape_and_global_offset(shape, mshape, list(coord),
                                                                   placements)
            got = [[o, o + n] for o, n in zip(offset, local)]
            assert got == per[",".join(map(str, coord))], (mesh_name, tokens, coord)


# --- the cache: replicated heads and layouts --------------------------------
def _walk(tree, is_leaf):
    """Leaves in JAX's order (dict keys sorted)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _walk(tree[k], is_leaf)]
    return [x for v in tree for x in _walk(v, is_leaf)]


@pytest.mark.parametrize("model", [1, 2, 4, 16])
def test_kv_cache_heads_and_cache_shardings_match_jax(model):
    from jax.sharding import NamedSharding

    shape, names = (2, model), ("data", "model")
    for name in configs.ARCHS:
        for get, jget in ((configs.get, jconfigs.get), (configs.get_smoke, jconfigs.get_smoke)):
            cfg, jcfg = get(name), jget(name)
            ours = MeshRules(_Mesh(shape, names))
            ref = JaxRules(AbstractMesh(shape, names))
            with use_rules(ours), jax_use_rules(ref):
                assert tf.kv_cache_heads(cfg) == jax_tf.kv_cache_heads(jcfg), (name, model)
                jax_cache = jax_tf.init_cache(jcfg, 8, 64, abstract=True)
                jax_sh = jax_tf.cache_shardings(jcfg, ref, 8, 64)
            got = [sh[1] for sh in _walk(tf.cache_shardings(cfg, ours, 8, 64),
                                         lambda x: isinstance(x, tuple))]
            leaves = _walk(jax_cache, lambda x: hasattr(x, "shape"))
            want = [ours.placements(tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec)))
                    for sh, leaf in zip(_walk(jax_sh, lambda x: isinstance(x, NamedSharding)),
                                        leaves)]
            assert got == want, (name, model)
