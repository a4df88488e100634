"""Port parity for models/mjcf.py: ``load_mjcf`` of the repository's MJCF
assets gives the JAX package's topology, geoms, motor table and defaults
exactly (numpy on both sides), and forward kinematics at the zero pose puts
every body where the MJCF's cumulative body positions and joint anchors say,
and where the JAX package puts it, at atol 1e-5 (float32 sums down a chain
of about 1 m)."""
import os
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.models.mjcf import load_mjcf as jax_load_mjcf
from thormang_isaacgym_tpu.ops.kinematics import forward_kinematics as jax_fk
from thormang_isaacgym_tpu_torch.models import load_mjcf
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics

ASSETS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "assets", "mjcf"))
NAMES = ["nv_humanoid", "nv_ant"]


def _path(name):
    return os.path.join(ASSETS, f"{name}.xml")


@pytest.mark.parametrize("name", NAMES)
def test_load_mjcf_matches_jax_exactly(name):
    m, j = load_mjcf(_path(name)), jax_load_mjcf(_path(name))
    for field in ("name", "body_names", "parent", "joint_names", "joint_type", "joint_axis",
                  "joint_pos", "joint_quat", "dof_index", "floating", "n_roots"):
        assert getattr(m, field) == getattr(j, field), field
    assert len(m.geoms) == len(j.geoms)
    for gm, gj in zip(m.geoms, j.geoms):
        assert (gm.body, gm.gtype, gm.size, gm.pos, gm.quat, gm.name) == \
            (gj.body, gj.gtype, gj.size, gj.pos, gj.quat, gj.name)
    np.testing.assert_array_equal(m.motor_efforts, np.asarray(j.motor_efforts))
    assert sorted(m._defaults) == sorted(j._defaults)
    for k, v in j._defaults.items():
        got = np.asarray(m._defaults[k])
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_nv_humanoid_counts():
    """21 DOFs on 22 bodies (nine near-massless chain links), a gear table
    for every joint, and the chain links' floors of load_mjcf."""
    m = load_mjcf(_path("nv_humanoid"))
    assert (m.nb, m.nj, m.floating) == (22, 21, True)
    assert (np.asarray(m.motor_efforts) > 0).all()
    links = [i for i, n in enumerate(m.body_names) if "__j" in n]
    assert len(links) == 9
    d = m._defaults
    assert (d["body_mass"][links] == np.float32(1e-3)).all()
    # inertia max(m 2.5e-3, 1e-7) from the float32 mass
    np.testing.assert_allclose(d["body_inertia"][links].diagonal(axis1=1, axis2=2),
                               np.full((9, 3), 2.5e-6), rtol=1e-6)


def _expected_zero_pose(path):
    """Each body frame at the zero pose: the cumulative <body pos> plus the
    body's first joint anchor, relative to the root (the nv_* bodies have no
    quat or euler attributes)."""
    expected = {}

    def walk(el, base):
        pos = base + np.array([float(x) for x in el.get("pos", "0 0 0").split()])
        jel = el.find("joint")
        anchor = np.zeros(3)
        if jel is not None and jel.get("type") != "free":
            anchor = np.array([float(x) for x in jel.get("pos", "0 0 0").split()])
        expected[el.get("name")] = pos + anchor
        for c in el.findall("body"):
            walk(c, pos)

    root = ET.parse(path).getroot().find("worldbody").find("body")
    walk(root, np.zeros(3))
    root_pos = expected[root.get("name")]
    return {k: v - root_pos for k, v in expected.items()}


@pytest.mark.parametrize("name", NAMES)
def test_zero_pose_forward_kinematics(name):
    m = load_mjcf(_path(name))
    q = torch.zeros(1, m.nq)
    q[0, 3] = 1.0
    frames = forward_kinematics(m, q, torch.zeros(1, m.nv))
    pos = frames.pos[0].numpy()
    jq = jnp.zeros(m.nq).at[3].set(1.0)
    jpos = np.asarray(jax_fk(jax_load_mjcf(_path(name)), jq, jnp.zeros(m.nv)).pos)
    np.testing.assert_allclose(pos, jpos, atol=1e-5)
    for body, exp in _expected_zero_pose(_path(name)).items():
        np.testing.assert_allclose(pos[m.body_id(body)], exp, atol=1e-5, err_msg=body)
    if name == "nv_humanoid":
        assert abs(pos[m.body_id("right_foot")][2] - (-1.178)) < 1e-3
