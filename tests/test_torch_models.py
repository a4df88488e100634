"""Port parity: the URDF compiler of the PyTorch package produces the same
static model and the same ``_defaults`` arrays as the JAX package's (exact
equality) for assets/cartpole.urdf and the generated Ant URDF."""
import os

import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.tasks.ant import make_ant_urdf as jax_ant_urdf
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.tasks.ant import make_ant_urdf

CARTPOLE = os.path.join(os.path.dirname(__file__), "..", "assets", "cartpole.urdf")
ASSETS = {
    "cartpole": (lambda f: f(CARTPOLE, fix_base_link=True)),
    "ant": (lambda f: f(jax_ant_urdf(), name="ant")),
}
STATIC = ("name", "body_names", "parent", "joint_names", "joint_type", "joint_axis",
          "joint_pos", "joint_quat", "floating", "geoms", "n_roots", "nq", "nv", "nb", "nj")


@pytest.fixture(scope="module")
def jax_models():
    return {k: build(jax_load_urdf) for k, build in ASSETS.items()}


def test_ant_urdf_string_matches():
    assert make_ant_urdf() == jax_ant_urdf()


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_defaults_equal(jax_models, asset):
    jm, tm = jax_models[asset], ASSETS[asset](load_urdf)
    assert sorted(jm._defaults) == sorted(tm._defaults)
    for k, v in jm._defaults.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(tm._defaults[k]), err_msg=k)
        assert np.asarray(v).dtype == np.asarray(tm._defaults[k]).dtype, k


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_static_topology_equal(jax_models, asset):
    jm, tm = jax_models[asset], ASSETS[asset](load_urdf)
    for attr in STATIC:
        a, b = getattr(jm, attr), getattr(tm, attr)
        if attr == "geoms":
            a = [(g.body, g.gtype, g.size, g.pos, g.quat, g.name) for g in a]
            b = [(g.body, g.gtype, g.size, g.pos, g.quat, g.name) for g in b]
        assert a == b, attr


def test_model_params_batch_and_to():
    m = load_urdf(make_ant_urdf(), name="ant")
    p = m.default_params().batch(3)
    assert p.body_mass.shape == (3, m.nb) and p.body_inertia.shape == (3, m.nb, 3, 3)
    assert p.drive_mode.dtype == torch.int32
    p.body_mass[0, 0] = 123.0          # leaves are independent copies per env
    assert float(p.body_mass[1, 0]) != 123.0
    assert p.to("cpu").gravity.device.type == "cpu"


def test_convert_model_params_from_jax(jax_models):
    from thormang_isaacgym_tpu_torch.parity import convert
    jp = jax_models["ant"].default_params()
    leaves = {k: np.asarray(getattr(jp, k)) for k in jp.__dataclass_fields__}
    got = convert.model_params(leaves)
    want = ASSETS["ant"](load_urdf).default_params()
    for k in leaves:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
