"""PDE trajectory data: openers, RAM and disk caches, synthetic trajectories,
the host window streams and the time-conditioned windows.

Subset of ``unet_design_tpu/data/pde.py``, kept free of JAX.  The trainers
stack a split that fits the device into one ``(N, T, H, W, C)`` array
(:meth:`CachedOpener.stacked_fields`), move it to the device once and
gather windows there; a split that does not fit streams from the host
through :func:`randomized_train_windows` / :func:`eval_timestep_windows` /
:func:`rollout_eval_trajectories` and :func:`batched_windows`, which yield
the windows that the device path gathers, in the same order.  For the
conditioned trainer, :func:`time_conditioned_pairs` and
:func:`conditioned_eval_pairs` give the (trajectory, start, end) of the
windows that JAX's time-conditioned generators yield, in their order, in
place of the generators.  ``h5py`` (NS-2D) and ``xarray`` (SW-2D
``.zarr``) are imported only where a file is read.

Frames are NHWC: u (T, H, W, n_scalar), v (T, H, W, 2 * n_vector).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import logging
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class PDEDataConfig:
    n_scalar_components: int
    n_vector_components: int
    trajlen: int
    n_spatial_dims: int = 2


def max_start_time(trajlen: int, time_history: int, time_future: int,
                   time_gap: int) -> int:
    return trajlen - time_history - time_future - time_gap


def create_data2d(n_input_scalar: int, n_input_vector: int,
                  n_output_scalar: int, n_output_vector: int,
                  scalar_fields: Optional[np.ndarray],
                  vector_fields: Optional[np.ndarray],
                  start: int, time_history: int, time_future: int,
                  time_gap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Slice one trajectory into (input, target) (``data/utils.py:17-71``):
    ``scalar_fields (T, H, W, n_scalar)``, ``vector_fields (T, H, W, 2
    n_vector)`` -> ``(1, time_history, H, W, C_in)``, ``(1, time_future,
    H, W, C_out)``."""
    if not (n_input_scalar > 0 or n_input_vector > 0) or time_history <= 0:
        raise ValueError("a window needs input fields and a history")
    end = start + time_history
    tstart = end + time_gap
    tend = tstart + time_future
    parts_in, parts_out = [], []
    if n_input_scalar > 0:
        parts_in.append(scalar_fields[start:end, ..., :n_input_scalar])
    if n_input_vector > 0:
        parts_in.append(vector_fields[start:end, ..., :n_input_vector * 2])
    if n_output_scalar > 0:
        parts_out.append(scalar_fields[tstart:tend, ..., :n_output_scalar])
    if n_output_vector > 0:
        parts_out.append(vector_fields[tstart:tend, ..., :n_output_vector * 2])
    data = np.concatenate(parts_in, axis=-1)[None]
    targets = np.concatenate(parts_out, axis=-1)[None]
    if targets.shape[-1] == 0:
        raise ValueError("No targets")
    return data, targets


def _window(pde: PDEDataConfig, u, v, start: int, th: int, tf: int,
            tg: int):
    ns, nv = pde.n_scalar_components, pde.n_vector_components
    return create_data2d(ns, nv, ns, nv, u, v, start, th, tf, tg)


def randomized_train_windows(opener, pde: PDEDataConfig, time_history: int,
                             time_future: int, time_gap: int,
                             seed: int = 0, cycles: Optional[int] = None
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """RandomizedPDETrainData (``datapipes/common.py:251-319``): ``cycles``
    passes over the opener (default ``trajlen``), one window per
    trajectory visit, its start one scalar ``rng.integers(0, mst + 1)`` of
    ``default_rng(seed)``: the stream the device path draws at once."""
    rng = np.random.default_rng(seed)
    cycles = pde.trajlen if cycles is None else cycles
    mst = max_start_time(pde.trajlen, time_history, time_future, time_gap)
    for _ in range(cycles):
        for (u, v, _) in opener:
            start = int(rng.integers(0, mst + 1))
            yield _window(pde, u, v, start, time_history, time_future,
                          time_gap)


def eval_timestep_windows(opener, pde: PDEDataConfig, time_history: int,
                          time_future: int, time_gap: int
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """PDEEvalTimeStepData (``datapipes/common.py:322-392``): the windows at
    starts ``0, tf + tg, ...``, start-major, trajectory-minor."""
    mst = max_start_time(pde.trajlen, time_history, time_future, time_gap)
    for start in range(0, mst + 1, time_gap + time_future):
        for (u, v, _) in opener:
            yield _window(pde, u, v, start, time_history, time_future,
                          time_gap)


def rollout_eval_trajectories(opener) -> Iterator[Tuple[np.ndarray, ...]]:
    """Whole trajectories for the rollout validation."""
    for (u, v, cond) in opener:
        yield u, v, cond


def batched_windows(window_iter, batch_size: int
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Concatenate windows into batches of ``batch_size``; a partial tail
    batch is dropped."""
    xs, ys = [], []
    for x, y in window_iter:
        xs.append(x)
        ys.append(y)
        if len(xs) == batch_size:
            yield np.concatenate(xs), np.concatenate(ys)
            xs, ys = [], []


def _conditioned_pair(rng: np.random.Generator, trajlen: int,
                      reweigh: bool):
    """One draw of (start, end): ``end ~ U[1, trajlen)``, ``start`` in
    ``[0, end)`` weighted ``1 / (end - start)`` toward long horizons."""
    end = int(rng.integers(1, trajlen))
    if reweigh:
        w = 1.0 / np.arange(1, end + 1)
        start = int(rng.choice(np.arange(0, end), p=w / w.sum()))
    else:
        start = int(rng.integers(0, end))
    return start, end


def time_conditioned_pairs(n_traj: int, trajlen: int, seed: int = 0,
                           reweigh: bool = True,
                           cycles: Optional[int] = None) -> np.ndarray:
    """``(3, n)`` int array of (trajectory, start, end): the windows of
    JAX's ``random_time_conditioned_windows`` (``RandomTimeStepConditioned
    PDETrainData``, ``common.py:148-208``) over ``n_traj`` trajectories, in
    its order and from the same numpy stream: ``cycles`` passes, one pair
    per trajectory."""
    rng = np.random.default_rng(seed)
    cycles = trajlen if cycles is None else cycles
    rows = [(i, *_conditioned_pair(rng, trajlen, reweigh))
            for _ in range(cycles) for i in range(n_traj)]
    return np.asarray(rows, np.int64).reshape(-1, 3).T


def _check_eval_delta_t(trajlen: int, delta_t: int) -> None:
    if 2 * delta_t >= trajlen:
        raise ValueError("delta_t should be less than half the trajlen")


def conditioned_eval_pairs(n_traj: int, n_frames: int, trajlen: int,
                           delta_t: int) -> np.ndarray:
    """``(3, n)`` int array of (trajectory, start frame, end frame): the
    windows of JAX's ``timestep_conditioned_eval_windows``
    (``TimestepConditionedPDEEvalData``, ``common.py:211-248``) over
    ``n_traj`` trajectories of ``n_frames`` frames, in its order: for each
    offset ``begin < trajlen - delta_t``, each trajectory's consecutive
    pairs of its frames ``begin::delta_t``."""
    _check_eval_delta_t(trajlen, delta_t)
    rows = []
    for begin in range(trajlen - delta_t):
        frames = range(begin, n_frames, delta_t)
        for i in range(n_traj):
            rows.extend((i, a, b) for a, b in zip(frames, frames[1:]))
    return np.asarray(rows, np.int64).reshape(-1, 3).T


class NavierStokesOpener:
    """Yields (u, v, cond) trajectories from PDEArena NS-2D HDF5 files."""

    def __init__(self, paths: Sequence[str], mode: str,
                 limit_trajectories: Optional[int] = None):
        self.paths = list(paths)
        self.mode = mode
        self.limit = limit_trajectories

    @staticmethod
    def list_files(data_path: str, mode: str) -> List[str]:
        files = sorted(glob.glob(os.path.join(data_path, "*.h5")))
        return [f for f in files if mode in os.path.basename(f)]

    def n_trajectories(self) -> int:
        import h5py
        total = 0
        for path in self.paths:
            with h5py.File(path, "r") as f:
                num = f[self.mode]["u"].shape[0]
                if self.limit not in (None, -1):
                    num = min(num, self.limit)
                total += num
        return total

    def __iter__(self):
        import h5py
        for path in self.paths:
            with h5py.File(path, "r") as f:
                data = f[self.mode]
                num = data["u"].shape[0]
                if self.limit not in (None, -1):
                    num = min(num, self.limit)
                for idx in range(num):
                    u = np.asarray(data["u"][idx], np.float32)[..., None]
                    v = np.stack([np.asarray(data["vx"][idx], np.float32),
                                  np.asarray(data["vy"][idx], np.float32)],
                                 axis=-1)
                    cond = (np.float32(data["buo_y"][idx])
                            if "buo_y" in data else None)
                    yield u, v, cond


class ShallowWaterOpener:
    """Shallow-water-2D reader (``datapipes/shallowwater2d.py:17-165``):
    vorticity (scalar) and wind (vector), vorticity normalised by the
    dataset's ``normstats.npz``; ``.npz`` trajectories or ``.zarr`` (needs
    xarray).  ``[skip_nt::sample_rate]`` subsamples time when
    ``sample_rate > 1``."""

    def __init__(self, paths: Sequence[str], mode: str,
                 limit_trajectories: Optional[int] = None,
                 skip_nt: int = 0, sample_rate: int = 1):
        self.paths = list(paths)
        self.mode = mode
        self.limit = limit_trajectories
        self.skip_nt = skip_nt
        self.sample_rate = sample_rate

    def _subsample(self, arr: np.ndarray) -> np.ndarray:
        if self.sample_rate > 1:
            return arr[self.skip_nt::self.sample_rate]
        return arr

    @staticmethod
    def list_files(data_path: str, mode: str) -> List[str]:
        return [os.path.join(data_path, name)
                for name in sorted(os.listdir(data_path))
                if name.startswith(mode)
                and (name.endswith(".zarr") or name.endswith(".npz"))]

    def n_trajectories(self) -> int:
        n = len(self.paths)
        if self.limit not in (None, -1):
            n = min(n, self.limit)
        return n

    def __iter__(self):
        for count, path in enumerate(self.paths):
            if self.limit not in (None, -1) and count >= self.limit:
                return
            if path.endswith(".npz"):
                d = np.load(path)
                u = np.asarray(d["u"], np.float32)
                normpath = os.path.join(os.path.dirname(path),
                                        "normstats.npz")
                if os.path.exists(normpath):
                    ns = np.load(normpath)
                    u = (u - ns["vor_mean"]) / ns["vor_std"]
                yield (self._subsample(u),
                       self._subsample(np.asarray(d["v"], np.float32)), None)
                continue
            try:
                import xarray as xr
            except ImportError as e:
                raise ImportError(
                    "ShallowWaterOpener needs xarray+zarr for .zarr data; "
                    "convert to .npz with scripts/convert_shallowwater.py"
                ) from e
            ds = xr.open_zarr(path)
            normpath = os.path.join(os.path.dirname(path), "..",
                                    "normstats.npz")
            vor = np.asarray(ds["vor"].values, np.float32)
            if os.path.exists(normpath):
                ns = np.load(normpath)
                vor = (vor - ns["vor_mean"]) / ns["vor_std"]
            u = vor.reshape(vor.shape[0], *vor.shape[-2:])[..., None]
            v = np.stack([np.asarray(ds["u"].values, np.float32)
                          .reshape(u.shape[:3]),
                          np.asarray(ds["v"].values, np.float32)
                          .reshape(u.shape[:3])], axis=-1)
            yield self._subsample(u), self._subsample(v), None


class CachedOpener:
    """RAM-resident wrapper around any trajectory opener: read each file
    once, serve the arrays afterwards."""

    def __init__(self, opener):
        self._trajs = list(opener)

    def __iter__(self):
        return iter(self._trajs)

    def __len__(self):
        return len(self._trajs)

    def n_trajectories(self) -> int:
        return len(self._trajs)

    def stacked_fields(self) -> np.ndarray:
        """(N, T, H, W, C_scalar + 2*C_vector): scalar fields then vector
        fields, the window's channel order."""
        return np.stack([np.concatenate([u, v], axis=-1) if v is not None
                         else u for (u, v, _) in self._trajs])


class StackedDiskCache:
    """Opener view over one pre-stacked fields array (see
    :func:`cached_opener`)."""

    def __init__(self, fields: np.ndarray, n_scalar: int):
        self._fields = fields
        self._ns = n_scalar

    def __iter__(self):
        for f in self._fields:
            v = f[..., self._ns:]
            yield f[..., :self._ns], (v if v.shape[-1] else None), None

    def __len__(self):
        return len(self._fields)

    def n_trajectories(self) -> int:
        return len(self._fields)

    def stacked_fields(self) -> np.ndarray:
        return self._fields


def opener_cache_key(opener) -> Optional[str]:
    """Fingerprint of an opener's files (names, sizes, mtimes), of any
    ``normstats.npz`` it would read, and of its read parameters; None when
    the opener has no file list."""
    paths = getattr(opener, "paths", None)
    if not paths:
        return None
    h = hashlib.sha1()
    for p in paths:
        st = os.stat(p)
        h.update(f"{os.path.basename(p)}:{st.st_size}:"
                 f"{st.st_mtime_ns};".encode())
    norm_dirs = []
    for p in paths:  # .npz: sibling normstats; .zarr: parent-dir normstats
        d = os.path.dirname(os.path.abspath(p))
        for nd in (d, os.path.dirname(d)):
            if nd not in norm_dirs:
                norm_dirs.append(nd)
    for nd in norm_dirs:
        np_path = os.path.join(nd, "normstats.npz")
        if os.path.exists(np_path):
            st = os.stat(np_path)
            h.update(f"norm:{np_path}:{st.st_size}:"
                     f"{st.st_mtime_ns};".encode())
        else:
            h.update(f"norm:{np_path}:missing;".encode())
    h.update(f"|limit={getattr(opener, 'limit', None)}"
             f"|skip={getattr(opener, 'skip_nt', 0)}"
             f"|rate={getattr(opener, 'sample_rate', 1)}"
             f"|mode={getattr(opener, 'mode', '')}".encode())
    return h.hexdigest()


def cached_opener(opener, n_scalar: Optional[int] = None,
                  cache_dir: Optional[str] = None):
    """RAM-cache an opener; with ``cache_dir``, also keep the stacked array
    on disk, keyed by :func:`opener_cache_key`, and load that single array
    on later runs.  Openers the stack cannot represent (conditioned or
    ragged trajectories, no file list) get a plain :class:`CachedOpener`."""
    if cache_dir is None or n_scalar is None:
        return CachedOpener(opener)
    key = opener_cache_key(opener)
    if key is None:
        return CachedOpener(opener)
    key = f"{key}|ns={n_scalar}"
    digest = hashlib.sha1(key.encode()).hexdigest()[:16]
    path = os.path.join(
        cache_dir, f"stack_{getattr(opener, 'mode', 'x')}_{digest}.npz")
    if os.path.exists(path):
        try:
            d = np.load(path)
            if str(d["key"]) == key:
                _log.info("stacked cache hit: %s", path)
                return StackedDiskCache(np.asarray(d["fields"]),
                                        int(d["n_scalar"]))
        except (OSError, ValueError, KeyError):  # corrupt/foreign: rebuild
            pass
    cached = CachedOpener(opener)
    trajs = cached._trajs
    if (not trajs or any(c is not None for (_, _, c) in trajs)
            or any(v is None for (_, v, _) in trajs)
            or len({(u.shape, v.shape) for (u, v, _) in trajs}) != 1
            or trajs[0][0].shape[-1] != n_scalar):
        return cached
    fields = cached.stacked_fields()
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, fields=fields, key=np.array(key),
                 n_scalar=np.array(n_scalar))
    os.replace(tmp, path)
    _log.info("stacked cache saved: %s %s (%.2f GB)", path, fields.shape,
              fields.nbytes / 1e9)
    return StackedDiskCache(fields, n_scalar)


def synthetic_trajectories(n_traj: int, pde: PDEDataConfig, res: int = 32,
                           seed: int = 0):
    """Smooth random trajectories (superposed decaying Fourier modes); the
    same numbers as the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(res)[:, None] ** 2 + np.fft.fftfreq(res)[None, :] ** 2
    trajs = []
    for _ in range(n_traj):
        def field(t_decay):
            spec = (rng.standard_normal((res, res))
                    + 1j * rng.standard_normal((res, res)))
            spec *= np.exp(-400 * k)
            frames = [np.real(np.fft.ifft2(spec * np.exp(-t_decay * t * k)))
                      for t in range(pde.trajlen)]
            out = np.stack(frames).astype(np.float32)
            return out / (np.abs(out).max() + 1e-8)

        u = np.stack([field(5.0) for _ in
                      range(pde.n_scalar_components)], axis=-1)
        v = (np.stack([field(5.0) for _ in
                       range(2 * pde.n_vector_components)], axis=-1)
             if pde.n_vector_components else None)
        trajs.append((u, v, None))
    return trajs
