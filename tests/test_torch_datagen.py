"""Port parity: PDE data generation (the Navier-Stokes smoke, shallow-water
and Maxwell solvers, their writers, and the generate / normalize / convert
entry points) against the JAX package, on the CPU at small sizes.

The operators are held at 1e-5 of their scale.  Trajectories start from
the initial noise that JAX draws from the same key (computed here with
JAX and handed to the port: the torch and JAX streams differ) and are held
against JAX's ``simulate_trajectory`` at tolerances measured on the CPU
and stated at each test: semi-Lagrangian advection and the RK4 steps
carry fp32 differences forward, so whole trajectories are compared over a
few frames only.  Maxwell's sources are numpy's and identical in both
packages, so its trajectories and written files are compared directly.
"""
import dataclasses
import importlib.util
import os
import sys
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.data import pde as jdata
from unet_design_tpu.datagen import maxwell as jmx
from unet_design_tpu.datagen import navier_stokes as jns
from unet_design_tpu.datagen import pde_configs as jcfg
from unet_design_tpu.datagen import shallow_water as jsw
from unet_design_tpu_torch.datagen import maxwell as tmx
from unet_design_tpu_torch.datagen import navier_stokes as tns
from unet_design_tpu_torch.datagen import pde_configs as tcfg
from unet_design_tpu_torch.datagen import shallow_water as tsw
from unet_design_tpu_torch.tasks import compute_normalization as tnorm
from unet_design_tpu_torch.tasks import convert_shallowwater as tconvert
from unet_design_tpu_torch.tasks import generate_data as tgen
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _script(name):
    """A module of ``scripts/`` (the JAX entry points), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close_to_scale(got, want, rel, what=""):
    """``|got - want| <= rel * max|want|`` (the field's scale)."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    scale = max(float(np.abs(want).max()), 1e-12)
    assert err <= rel * scale, f"{what}: {err:.3g} > {rel} x {scale:.3g}"


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("name,over", [
    ("NavierStokes2D", {}), ("NavierStokes2D", dict(nt=56, sample_rate=4)),
    ("ShallowWaterWeather", {}), ("ShallowWaterWeather", dict(nx=24)),
    ("Maxwell3D", {}), ("Maxwell3D", dict(nx=8, ny=8, nz=8))])
def test_pde_configs_match(name, over):
    j = dataclasses.replace(getattr(jcfg, name)(), **over)
    t = dataclasses.replace(getattr(tcfg, name)(), **over)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert str(j) == str(t)
    for prop in ("grid_size", "trajlen", "dt", "n_large", "grid_spacing"):
        assert getattr(j, prop, None) == getattr(t, prop, None), prop


# ------------------------------------------------- Navier-Stokes operators

@pytest.mark.parametrize("shape", [(16, 16), (12, 20)])
def test_advect_matches_jax(shape):
    """Random fields and velocities large enough that most departure
    points cross the periodic seam, at 1e-5."""
    f, vx, vy = _x((3, 2) + shape, 1), _x((2,) + shape, 2), _x((2,) + shape, 3)
    dt = 2.7
    out = tns.advect(_t(f).transpose(0, 1), _t(vx), _t(vy), dt)
    for b in range(2):
        for k in range(3):
            ref = jns._advect(jnp.asarray(f[k, b]), jnp.asarray(vx[b]),
                              jnp.asarray(vy[b]), dt)
            np.testing.assert_allclose(out[b, k].numpy(), np.asarray(ref),
                                       **OP_TOL)


def test_advect_wrap_seam():
    """Linear interpolation with period n: on ``[0, 1, 2, 3]`` a point at
    3.5 or -0.5 reads (3 + 0) / 2, as JAX's ``map_coordinates(order=1,
    mode="wrap")`` does (scipy's ``wrap`` differs)."""
    ref = jax.scipy.ndimage.map_coordinates(
        jnp.arange(4.0), [jnp.asarray([3.5, -0.5, 0.25])], order=1,
        mode="wrap")
    np.testing.assert_allclose(np.asarray(ref), [1.5, 1.5, 0.25])
    field = torch.arange(4.0)[:, None].expand(4, 2)[None, None].contiguous()
    # departure points x - dt vx: row 0 at -0.5, row 3 at 3.5
    vx = torch.tensor([[0.5], [0.0], [0.0], [-0.5]]).expand(4, 2)[None]
    out = tns.advect(field, vx.contiguous(), torch.zeros(1, 4, 2), 1.0)
    np.testing.assert_allclose(out[0, 0, :, 0].numpy(), [1.5, 1.0, 2.0, 1.5])


def test_project_and_diffuse_match_jax():
    vx, vy = _x((2, 16, 12), 4), _x((2, 16, 12), 5)
    px, py = tns.project(_t(vx), _t(vy))
    for b in range(2):
        jx, jy = jns._project(jnp.asarray(vx[b]), jnp.asarray(vy[b]))
        np.testing.assert_allclose(px[b].numpy(), np.asarray(jx), **OP_TOL)
        np.testing.assert_allclose(py[b].numpy(), np.asarray(jy), **OP_TOL)
        np.testing.assert_allclose(
            tns.diffuse(_t(vx), 0.05, 0.3)[b].numpy(),
            np.asarray(jns._diffuse(jnp.asarray(vx[b]), 0.05, 0.3)),
            **OP_TOL)
    # divergence free, the Nyquist row and column empty
    g = tns.Grid(16, 12, "cpu")
    div = g.kx * torch.fft.fft2(px) + g.ky * torch.fft.fft2(py)
    assert float(div.abs().max()) < 1e-5


@pytest.mark.parametrize("shape,nu,dt", [((16, 16), 0.05, 0.3),
                                         ((12, 20), 0.01, 3.3),
                                         ((15, 9), 0.05, 1.0)])
def test_fused_step_matches_jax_fft_route(shape, nu, dt):
    """The port's diffusion then projection, the step ``simulate`` takes,
    against JAX's FFT route (``_diffuse`` then ``_project``) at 1e-5, on
    square, non-square and odd grids."""
    vx, vy = _x((2,) + shape, 6), _x((2,) + shape, 7)
    g = tns.Grid(*shape, "cpu")
    ox, oy = tns.project(tns.diffuse(_t(vx), nu, dt, g),
                         tns.diffuse(_t(vy), nu, dt, g), g)
    for b in range(2):
        jx, jy = jns._project(jns._diffuse(jnp.asarray(vx[b]), nu, dt),
                              jns._diffuse(jnp.asarray(vy[b]), nu, dt))
        np.testing.assert_allclose(ox[b].numpy(), np.asarray(jx), **OP_TOL)
        np.testing.assert_allclose(oy[b].numpy(), np.asarray(jy), **OP_TOL)


def _ns_pde(mod, **kw):
    return mod.NavierStokes2D(nx=16, ny=16, nt=6, skip_nt=2, sample_rate=1,
                              nu=0.05, **kw)


def _jax_ns_noise(key, nx, ny):
    """The normal draws behind JAX's initial state for ``key``: per
    ``split(key, 3)`` field, the real and imaginary spectra."""
    return np.stack([np.stack([
        np.asarray(jax.random.normal(r, (nx, ny))),
        np.asarray(jax.random.normal(jax.random.fold_in(r, 1), (nx, ny)))])
        for r in jax.random.split(key, 3)])


@pytest.fixture(scope="module")
def jax_ns():
    """JAX's trajectory and initial state for one key (jitted once)."""
    key = jax.random.PRNGKey(3)
    pde = _ns_pde(jcfg)
    r1, r2, r3 = jax.random.split(key, 3)
    smoke = jnp.abs(jns._smooth_noise(r1, 16, 16))
    smoke = smoke / (jnp.max(smoke) + 1e-8)
    vx, vy = jns._project(jns._smooth_noise(r2, 16, 16, scale=0.2),
                          jns._smooth_noise(r3, 16, 16, scale=0.2))
    traj = [np.asarray(a) for a in jns.simulate_trajectory(key, pde)]
    return _jax_ns_noise(key, 16, 16), (smoke, vx, vy), traj


def test_initial_state_matches_jax(jax_ns):
    noise, init, _ = jax_ns
    for got, want in zip(tns.initial_state(_t(noise[None]),
                                           _ns_pde(tcfg)), init):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   **OP_TOL)


def test_ns_trajectory_matches_jax(jax_ns):
    """8 steps (6 saved) from JAX's initial state at nu 0.05 and dt 3.3:
    every frame within 2e-5 of each field's scale (measured: 3.9e-6 of
    vy's 8.4)."""
    noise, _, want = jax_ns
    got = tns.simulate(*tns.initial_state(_t(noise[None]), _ns_pde(tcfg)),
                       _ns_pde(tcfg))
    for g, w, name in zip(got, want, ("u", "vx", "vy")):
        assert g.shape == (1,) + w.shape
        _assert_close_to_scale(g[0].numpy(), w, 2e-5, name)
    assert float(got[0].min()) > -1.0


def test_ns_buoyancy_override(jax_ns):
    """``buoyancy_y=`` steps as a config with that buoyancy does, bit for
    bit, and moves the fields away from the config's own buoyancy."""
    noise, _, _ = jax_ns
    pde = _ns_pde(tcfg)
    init = tns.initial_state(_t(noise[None]), pde)
    over = tns.simulate(*init, pde, buoyancy_y=0.2)
    cfg = tns.simulate(*init, dataclasses.replace(pde, buoyancy_y=0.2))
    for a, b in zip(over, cfg):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(over[2], tns.simulate(*init, pde)[2])


def test_ns_frame_schedule_and_divergence():
    """``skip_nt`` steps, then every ``sample_rate``-th of ``nt``; the last
    frame's spectral divergence below 1e-3 of the velocity scale (the JAX
    test's bound)."""
    pde = tcfg.NavierStokes2D(nx=16, ny=16, nt=6, skip_nt=1, sample_rate=2)
    noise = torch.stack([tns.draw_noise(tns.trajectory_generator(0, "train",
                                                                 i), 16, 16)
                         for i in range(2)])
    init = tns.initial_state(noise, pde)
    # the same dt (tmax / nt): every step of the first nt, then the frames
    full = tns.simulate(*init, dataclasses.replace(pde, skip_nt=0,
                                                   sample_rate=1))
    u, vx, vy = tns.simulate(*init, pde)
    assert u.shape == (2, pde.trajlen, 16, 16)
    torch.testing.assert_close(u, full[0][:, 1::2], rtol=0, atol=0)
    g = tns.Grid(16, 16, "cpu")
    div = g.kx * torch.fft.fft2(vx[:, -1]) + g.ky * torch.fft.fft2(vy[:, -1])
    assert float(div.abs().max()) < 1e-3 * max(float(vx.abs().max()), 1.0)


# ---------------------------------------------------------- shallow water

def test_sw_grid_matches_jax():
    """Wavenumbers and the 2/3 dealiasing mask bit for bit (the mask's
    edge mode 32 of 96 rows sits on an fp32 rounding)."""
    s = tsw.Solver(96, 192, "cpu")
    ky, kx = jsw._wavenumbers(96, 192, 2.0, 4.0)
    k2 = np.asarray(ky ** 2 + kx ** 2)
    np.testing.assert_array_equal(s.k2.numpy(), k2)
    np.testing.assert_array_equal(s.mask.numpy().astype(bool),
                                  np.asarray(jsw._dealias_mask(96, 192)))
    np.testing.assert_array_equal(s.ikx.imag.numpy(),
                                  np.broadcast_to(np.asarray(kx), (1, 97)))


def test_sw_to_grid_c2r_convention():
    """The inverse transform of a half spectrum that is not Hermitian in
    its DC and Nyquist columns equals ``jnp.fft.irfft2`` (pocketfft drops
    their imaginary parts)."""
    spec = _x((2, 12, 9), 8) + 1j * _x((2, 12, 9), 9)
    out = tsw.Solver(12, 16, "cpu").to_grid(_t(spec.astype(np.complex64)))
    ref = jnp.fft.irfft2(jnp.asarray(spec, jnp.complex64), s=(12, 16))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP_TOL)


@pytest.fixture(scope="module")
def jax_sw():
    pde = jcfg.ShallowWaterWeather(nt=3, nx=16, ny=32)
    key = jax.random.PRNGKey(1)
    r1, r2 = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(r, (16, 17)))
                      for r in (r1, r2)])
    return noise, [np.asarray(a) for a in jsw.simulate_trajectory(key, pde)]


def test_sw_trajectory_matches_jax(jax_sw):
    """3 frames of 128 RK4 steps each at 16 x 32 from JAX's initial
    spectrum: within 1e-5 of each field's scale (measured 2.0e-6 of the
    vorticity's 7.9, 1.5e-6 of the winds'); the vorticity neither dies nor
    blows up (std within 0.2-5x of frame 0)."""
    noise, want = jax_sw
    pde = tcfg.ShallowWaterWeather(nt=3, nx=16, ny=32)
    assert tsw.substeps_and_dt(pde)[0] == 128
    got = tsw.simulate(_t(noise[None]), pde)
    for g, w, name in zip(got, want, ("vor", "u", "v")):
        assert g.shape == (1,) + w.shape
        _assert_close_to_scale(g[0].numpy(), w, 1e-5, name)
    vor = got[0][0]
    assert 0.2 < float(vor[-1].std() / vor[0].std()) < 5


# ------------------------------------------------------------------ Maxwell

MX = dict(nx=8, ny=8, nz=8, nt=3, skip_nt=4, sample_rate=2)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("over", [MX, {}])
def test_sample_sources_identical(seed, over):
    j = jmx.sample_sources(np.random.RandomState(seed),
                           dataclasses.replace(jcfg.Maxwell3D(), **over))
    t = tmx.sample_sources(np.random.RandomState(seed),
                           dataclasses.replace(tcfg.Maxwell3D(), **over))
    for a, b in zip(j, t, strict=True):
        np.testing.assert_array_equal(a, b)


def test_curls_match_jax():
    f = _x((2, 6, 6, 6, 3), 10)
    for jf, tf in ((jmx._curl_E, tmx.curl_e), (jmx._curl_H, tmx.curl_h)):
        got = tf(_t(f).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        for b in range(2):
            np.testing.assert_allclose(got[b].numpy(),
                                       np.asarray(jf(jnp.asarray(f[b]))),
                                       **OP_TOL)


def test_maxwell_trajectory_matches_jax():
    """30 steps of spin-up and 4 frames of 5 from the same sources: within
    1e-5 of each field's scale (measured 4.6e-7 and 2.9e-7 of E's and
    H's); the source phases' ``sin`` differs from XLA's by 6e-8 at most
    here and over the default grid's periods (120-35,000 steps, 430
    steps).  div H stays 0 and the fields are finite and nonzero."""
    kw = dict(nx=8, ny=8, nz=8, nt=4, skip_nt=30, sample_rate=5)
    src = tmx.sample_sources(np.random.RandomState(5), tcfg.Maxwell3D(**kw))
    want = jmx.simulate_trajectory(tuple(jnp.asarray(s) for s in src),
                                   jcfg.Maxwell3D(**kw))
    d, h = tmx.simulate(tmx.stack_sources([src], "cpu"),
                        tcfg.Maxwell3D(**kw))
    for g, w, name in zip((d, h), want, ("d_field", "h_field")):
        assert g.shape == (1, 4, 8, 8, 8, 3)
        _assert_close_to_scale(g[0].numpy(), w, 1e-5, name)
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    # div H of the cropped frames (forward differences inside the crop)
    hh = h[0, -1]
    div = sum((hh[..., a].narrow(a, 1, 7) - hh[..., a].narrow(a, 0, 7))
              [:7, :7, :7] for a in range(3))
    assert float(div.abs().max()) < 1e-5 * float(hh.abs().max())


# ----------------------------------------------------------------- writers

def test_ns_writer_schema_and_jax_reader(tmp_path):
    """The JAX file name, groups, datasets and dtypes; the ``.tmp_`` file
    renamed (a stale one removed); JAX's opener reads what the port wrote,
    and ``compute_normalization`` equals JAX's on it."""
    pde = _ns_pde(tcfg)
    stale = tmp_path / ".tmp_ns2d_train_1_0.50000_3.h5"
    stale.write_bytes(b"partial")
    path = tns.generate_trajectories_smoke(pde, "train", 3, batch_size=2,
                                           dirname=str(tmp_path), seed=1,
                                           device="cpu")
    assert os.path.basename(path) == "ns2d_train_1_0.50000_3.h5"
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    with h5py.File(path, "r") as f:
        g = f["train"]
        assert set(g) == {"u", "vx", "vy", "t", "dt", "x", "dx", "y", "dy",
                          "buo_y"}
        for k in ("u", "vx", "vy"):
            assert g[k].shape == (3, 6, 16, 16) and g[k].dtype == np.float32
        for k in ("t", "dt", "x", "dx", "y", "dy", "buo_y"):
            assert g[k].dtype == np.float64
        np.testing.assert_array_equal(g["buo_y"][:], 0.5)
    trajs = list(jdata.NavierStokesOpener([path], "train"))
    assert len(trajs) == 3 and trajs[0][0].shape == (6, 16, 16, 1)
    assert trajs[0][1].shape == (6, 16, 16, 2) and trajs[0][2] == 0.5
    # a trajectory does not depend on the batch it was made in
    again = tns.generate_trajectories_smoke(
        pde, "train", 3, batch_size=3, dirname=str(tmp_path / "b"), seed=1,
        device="cpu")
    with h5py.File(path, "r") as a, h5py.File(again, "r") as b:
        np.testing.assert_allclose(a["train"]["u"][:], b["train"]["u"][:],
                                   rtol=1e-6, atol=1e-7)
    ours = tns.compute_normalization([path], "train")
    ref = jns.compute_normalization([path], "train")
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == ref[k], k
    valid = tns.generate_trajectories_smoke(pde, "valid", 2,
                                            dirname=str(tmp_path), seed=1,
                                            device="cpu")
    assert os.path.basename(valid) == "ns2d_valid_1_0.50000.h5"
    with h5py.File(path, "r") as a, h5py.File(valid, "r") as b:
        assert not np.allclose(a["train"]["u"][0], b["valid"]["u"][0])


def _sw_pde(mod):
    return mod.ShallowWaterWeather(nt=2, nx=8, ny=16)


def test_sw_writer_normstats_and_splits(tmp_path):
    """``{mode}_seed{i}.npz`` in the opener's schema; ``normstats.npz`` from
    the train split only (float64 sums), which a valid split does not
    clobber; the splits of one seed differ; JAX's opener reads the set."""
    pde = _sw_pde(tcfg)
    paths = tsw.generate_trajectories_shallowwater(
        pde, "train", 3, batch_size=2, dirname=str(tmp_path), seed=7,
        device="cpu")
    assert [os.path.basename(p) for p in paths] == [
        "train_seed0.npz", "train_seed1.npz", "train_seed2.npz"]
    vor = np.stack([np.load(p)["u"] for p in paths])
    d = np.load(paths[0])
    assert d["u"].shape == (2, 8, 16, 1) and d["v"].shape == (2, 8, 16, 2)
    assert d["u"].dtype == d["v"].dtype == np.float32
    stats = dict(np.load(tmp_path / "normstats.npz"))
    v64 = vor.astype(np.float64)
    np.testing.assert_allclose(stats["vor_mean"], v64.mean(), rtol=0,
                               atol=1e-6 * v64.std())
    np.testing.assert_allclose(stats["vor_std"], v64.std(), rtol=1e-6)
    for mode in ("valid", "test"):
        tsw.generate_trajectories_shallowwater(
            pde, mode, 1, dirname=str(tmp_path), seed=7, device="cpu")
    assert dict(np.load(tmp_path / "normstats.npz")) == stats
    firsts = [np.load(tmp_path / f"{m}_seed0.npz")["u"]
              for m in ("train", "valid", "test")]
    for i in range(3):
        assert not np.allclose(firsts[i], firsts[(i + 1) % 3])
    listed = jdata.ShallowWaterOpener.list_files(str(tmp_path), "train")
    assert listed == paths
    (u, v, _), *_ = list(jdata.ShallowWaterOpener(listed, "train"))
    np.testing.assert_allclose(u, (vor[0] - stats["vor_mean"])
                               / stats["vor_std"], rtol=1e-6, atol=1e-6)


def test_maxwell_writer_matches_jax(tmp_path):
    """Both packages' writers on the same seed: the same name, schema
    (float64 ``d_field`` / ``h_field``) and fields to 1e-5 of their scale
    (the same numpy sources); splits of one seed differ."""
    kw = dict(MX)
    jpath = jmx.generate_trajectories_maxwell(
        jcfg.Maxwell3D(**kw), "train", 3, batch_size=2,
        dirname=str(tmp_path / "jax"), seed=3)
    tpath = tmx.generate_trajectories_maxwell(
        tcfg.Maxwell3D(**kw), "train", 3, batch_size=2,
        dirname=str(tmp_path / "port"), seed=3, device="cpu")
    assert os.path.basename(tpath) == os.path.basename(jpath) == \
        "Maxwell3D_train_3_3.h5"
    assert os.listdir(tmp_path / "port") == ["Maxwell3D_train_3_3.h5"]
    with h5py.File(jpath, "r") as a, h5py.File(tpath, "r") as b:
        assert set(b) == {"train"} and set(b["train"]) == {"d_field",
                                                           "h_field"}
        for k in ("d_field", "h_field"):
            assert b["train"][k].shape == (3, 3, 8, 8, 8, 3)
            assert b["train"][k].dtype == np.float64
            _assert_close_to_scale(b["train"][k][:], a["train"][k][:], 1e-5,
                                   k)
    vpath = tmx.generate_trajectories_maxwell(
        tcfg.Maxwell3D(**kw), "valid", 1, dirname=str(tmp_path / "port"),
        seed=3, device="cpu")
    with h5py.File(tpath, "r") as a, h5py.File(vpath, "r") as b:
        assert not np.allclose(a["train"]["d_field"][0],
                               b["valid"]["d_field"][0])


# ---------------------------------------------------------- entry points

@pytest.mark.parametrize("pde", ["navierstokes2d", "shallowwater",
                                 "maxwell3d"])
def test_generate_data_cli(tmp_path, pde, capsys):
    """``tasks.generate_data`` with the JAX script's flags and ``--device
    cpu``: the JAX package's readers take what it writes."""
    sizes = {"navierstokes2d": ["--nx", "16", "--ny", "16", "--nt", "6"],
             "shallowwater": ["--nx", "8", "--ny", "16", "--nt", "2"],
             "maxwell3d": ["--nx", "8", "--nt", "2"]}[pde]
    out = tgen.main([pde, "--device", "cpu", "--samples", "2", "--mode",
                     "valid", "--dirname", str(tmp_path)] + sizes)
    assert "wrote" in capsys.readouterr().out
    if pde == "navierstokes2d":
        files = jdata.NavierStokesOpener.list_files(str(tmp_path), "valid")
        assert files == [out]
        (u, v, c), _ = list(jdata.NavierStokesOpener(files, "valid"))
        assert u.shape == (6, 16, 16, 1) and v.shape == (6, 16, 16, 2)
    elif pde == "shallowwater":
        files = jdata.ShallowWaterOpener.list_files(str(tmp_path), "valid")
        assert files == out and not os.path.exists(tmp_path /
                                                   "normstats.npz")
        (u, v, c), _ = list(jdata.ShallowWaterOpener(files, "valid"))
        assert u.shape == (2, 8, 16, 1) and v.shape == (2, 8, 16, 2)
    else:
        with h5py.File(out, "r") as f:
            assert f["valid"]["d_field"].shape == (2, 2, 8, 8, 8, 3)


def test_compute_normalization_cli_matches_jax_script(tmp_path):
    tns.generate_trajectories_smoke(_ns_pde(tcfg), "train", 2,
                                    dirname=str(tmp_path), seed=0,
                                    device="cpu")
    tnorm.main([str(tmp_path), "--out", str(tmp_path / "port.npz")])
    _script("compute_normalization").main(
        [str(tmp_path), "--out", str(tmp_path / "jax.npz")])
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(a) == set(b) == {"u_mean", "u_std", "vx_mean", "vx_std",
                                "vy_mean", "vy_std"}
    for k in a:
        assert a[k] == b[k], k


def test_convert_shallowwater_through_stub_xarray(tmp_path, monkeypatch):
    """Conversion with a stub ``xarray`` whose ``open_zarr`` serves arrays
    in SpeedyWeather's (time, 1, lat, lon) layout: the port writes what the
    JAX script writes; without xarray it fails naming it."""
    rng = np.random.default_rng(11)
    ds = {k: types.SimpleNamespace(values=rng.standard_normal((5, 1, 4, 6)))
          for k in ("vor", "u", "v")}
    monkeypatch.setitem(sys.modules, "xarray", types.SimpleNamespace(
        open_zarr=lambda path: ds))
    tconvert.main(["in.zarr", str(tmp_path / "port.npz")])
    _script("convert_shallowwater").main(["in.zarr",
                                          str(tmp_path / "jax.npz")])
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert a["u"].shape == (5, 4, 6, 1) and a["v"].shape == (5, 4, 6, 2)
    for k in ("u", "v"):
        np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.setitem(sys.modules, "xarray", None)
    with pytest.raises(ImportError, match="xarray"):
        tconvert.main(["in.zarr", str(tmp_path / "x.npz")])


# -------------------------------------------------------------- figures

def test_scalar_sequence_figures_match_jax():
    """The rollout panel draws what JAX's draws: per axes the same image
    arrays, colour maps and titles; one frame (one column) works too."""
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    from unet_design_tpu.utils import visualization as jvis
    from unet_design_tpu_torch.utils import visualization as tvis
    init, gt, pred = _x((2, 6, 5), 20), _x((3, 6, 5), 21), _x((3, 6, 5), 22)

    def drawn(fig):
        return [(ax.get_title(), [(im.get_cmap().name, np.asarray(
            im.get_array())) for im in ax.get_images()]) for ax in fig.axes]
    a = drawn(tvis.plot_scalar_sequence_comparison(init, gt, pred))
    b = drawn(jvis.plot_scalar_sequence_comparison(init, gt, pred))
    assert len(a) == len(b) == 12
    for (ta, ia), (tb, ib) in zip(a, b):
        assert ta == tb and [c for c, _ in ia] == [c for c, _ in ib]
        for (_, x), (_, y) in zip(ia, ib):
            np.testing.assert_array_equal(x, y)
    fig = tvis.plot_scalar_sequence_comparison(init[:1], gt[:1], pred[:1])
    assert len(fig.axes) == 4
    plt.close("all")
