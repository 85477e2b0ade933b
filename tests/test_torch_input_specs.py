"""The port's ``launch/input_specs.py`` against the JAX package's: the
same shapes, the same applicability and serving-variant rule, the same
``model_flops``, and inputs, decode caches and parameters of the
reference's shapes and dtypes for every config x shape (the port's made
under ``FakeTensorMode``: nothing allocated)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.launch import input_specs as J
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as T
from repro_torch.sharding import partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [(a, s) for a in list_archs() for s in J.SHAPES]
NP_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: np.float32,
             torch.int32: np.int32, torch.int8: np.int8}


def _spec(shape, dtype):
    """A zero-strided numpy array of ``shape`` (no memory): what
    ``bridge.flatten`` takes for a leaf."""
    return np.lib.stride_tricks.as_strided(np.zeros((), dtype), shape,
                                           (0,) * len(shape))


def _ref_flat(tree):
    return {k: (v.shape, str(v.dtype)) for k, v in bridge.flatten(
        jax.tree.map(lambda s: _spec(s.shape, s.dtype), tree)).items()}


def _port_flat(tree):
    def spec(t):
        return _spec(tuple(t.shape), NP_DTYPES[t.dtype])

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items() if k != "seq_sharded"}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return spec(x)
    return {k: (v.shape, str(v.dtype))
            for k, v in bridge.flatten(walk(tree)).items()}


def test_shapes_equal_the_reference():
    assert T.SHAPES == J.SHAPES


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_applicable_and_model_flops_equal_the_reference(arch, shape):
    assert T.applicable(get_config(arch), shape) == J.applicable(
        j_get_config(arch), shape)
    for variant in ("", "swa"):
        assert T.model_flops(get_config(arch, variant), shape) == \
            J.model_flops(j_get_config(arch, variant), shape)


CFG_FOR = """
import json, sys
from repro.configs import list_archs
from repro.launch.dryrun import _cfg_for
from repro.launch.input_specs import SHAPES
print(json.dumps({f"{a}|{s}": [c.name, ok, why, v] for a in list_archs()
                  for s in SHAPES for c, ok, why, v in [_cfg_for(a, s)]}))
"""


def test_cfg_for_equals_the_reference():
    """The dry-run's serving-variant rule (``_cfg_for``) for every pair;
    the reference's in a subprocess, since its module sets XLA_FLAGS at
    import."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", CFG_FOR], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout)
    got = {f"{a}|{s}": [c.name, ok, why, v] for a, s in PAIRS
           for c, ok, why, v in [dryrun._cfg_for(a, s)]}
    assert got == want


@pytest.mark.parametrize("arch", list_archs())
def test_params_shapes_equal_the_reference(arch):
    want = _ref_flat(J.params_shapes(j_get_config(arch)))
    with FakeTensorMode():
        model = T.params_shapes(get_config(arch), torch.bfloat16, "cpu")
    got = {k: (partition.reference_shape(v),
               str(np.dtype(NP_DTYPES[(v[0] if isinstance(v, list)
                                       else v).dtype])))
           for k, v in bridge.leaves(model).items()}
    assert got == {k: (tuple(s), d) for k, (s, d) in want.items()}


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_equal_the_reference(arch, shape):
    """Every input leaf (a decode cache's too) has the reference's shape
    and dtype, the long_500k pairs through their serving variant."""
    cfg, ok, _, variant = dryrun._cfg_for(arch, shape)
    if not ok:
        assert not J.applicable(j_get_config(arch, variant), shape)[0]
        return
    want = _ref_flat(J.input_specs(j_get_config(arch, variant), shape))
    with FakeTensorMode():
        got = _port_flat(T.input_specs(cfg, shape, torch.bfloat16, "cpu"))
    assert got == want
