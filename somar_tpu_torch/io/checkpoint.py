"""HDF5 checkpoints, restart and plot files of one level (PyTorch port of
`somar_tpu.io.checkpoint`).

Two layers:
  * pure functions that build a file's content as a tree, a nested dict
    whose key "attrs" holds the node's attributes and whose other keys
    hold datasets (numpy arrays) or groups (trees): `checkpoint_tree`,
    `plotfile_tree`, `chombo_plotfile_tree`, and `state_from_tree`, which
    reads a state back from a checkpoint tree;
  * a thin h5py layer, `write_tree` / `read_tree`, that stores such a tree
    in one HDF5 file and loads it back.  h5py is imported inside them, so
    the package imports on a host without it.

The layout is the JAX package's, so that a file written by either
package is read by the other: root attributes (iteration, time, dt,
num_levels, ndim, config_json), group `level_0` with nx/dx/x0/periodic
attributes and the datasets new_velocity_<m>, new_scalar_<c>, new_lambda,
old_* (the previous step's state, written for the field set of the
reference's files; resume reads only new_*), eLambda, ccPressure,
pressure and macPressure, plus a Chombo-layout view of the same state in
the same file (`<name>:datatype=0` LevelData datasets).  Plot files are
Chombo-format (VisIt-readable): `write_chombo_plotfile`.

Single level only: the AMR arguments of the JAX functions (fine states,
hierarchies, patch origins, weights, parent selections) raise
NotImplementedError: AMR checkpoints and plot files are slice 10 of the
port (ROADMAP A.5).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch


def _host(t) -> np.ndarray:
    """A host numpy copy of a tensor (never a view of it)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.asarray(t)


def _no_amr(**kw):
    given = sorted(k for k, v in kw.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: AMR checkpoints and plot files are slice "
            "10 of the port (ROADMAP A.5)")


# ---------------------------------------------------------------------------
# the h5py layer
# ---------------------------------------------------------------------------
def write_tree(path: str, tree: dict):
    """Store a tree in a new HDF5 file at path."""
    import h5py

    def put(g, node):
        for k, v in node.get("attrs", {}).items():
            g.attrs[k] = v
        for k, v in node.items():
            if k == "attrs":
                continue
            if isinstance(v, dict):
                put(g.create_group(k), v)
            else:
                g.create_dataset(k, data=v)

    with h5py.File(path, "w") as f:
        put(f, tree)


def read_tree(path: str) -> dict:
    """Load a whole HDF5 file as a tree."""
    import h5py

    def get(g):
        node = {"attrs": dict(g.attrs)}
        for k, v in g.items():
            node[k] = get(v) if isinstance(v, h5py.Group) else v[...]
        return node

    with h5py.File(path, "r") as f:
        return get(f)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _level_group(state, grid, old_state=None) -> dict:
    g = {"attrs": {"nx": np.asarray(grid.nx), "dx": np.asarray(grid.dx),
                   "x0": np.asarray(grid.x0),
                   "periodic": np.asarray(grid.periodic, dtype=np.int8)}}
    vel, scal = _host(state.vel), _host(state.scalars)
    for m in range(grid.ndim):
        g[f"new_velocity_{m}"] = vel[m]
    for c in range(scal.shape[0]):
        g[f"new_scalar_{c}"] = scal[c]
    g["new_lambda"] = _host(state.lam)
    if old_state is not None:
        ovel, oscal = _host(old_state.vel), _host(old_state.scalars)
        for m in range(grid.ndim):
            g[f"old_velocity_{m}"] = ovel[m]
        for c in range(oscal.shape[0]):
            g[f"old_scalar_{c}"] = oscal[c]
        g["old_lambda"] = _host(old_state.lam)
    g["eLambda"] = _host(state.e_lambda)
    g["ccPressure"] = _host(state.cc_phi)
    g["pressure"] = _host(state.pressure)
    g["macPressure"] = _host(state.mac_phi)
    return g


def checkpoint_tree(state, level, step: int, dt: float,
                    extra: Optional[dict] = None, old_state=None,
                    cfl: float = 0.0) -> dict:
    """The content of a checkpoint of one level's state, for exact
    resume."""
    grid = level.grid
    tree = {"attrs": {"iteration": step, "time": float(state.time),
                      "dt": float(dt), "num_levels": 1, "ndim": grid.ndim,
                      "config_json": json.dumps(extra or {})},
            "level_0": _level_group(state, grid, old_state)}
    _chombo_checkpoint_view(tree, state, level, step, dt, cfl, old_state)
    return tree


def write_checkpoint(path: str, state, level, step: int, dt: float,
                     extra: Optional[dict] = None,
                     fine_state=None, fine_grid=None, origin=None,
                     weights=None, parent_sels=None, old_state=None,
                     old_fine=None, hierarchy=None, cfl: float = 0.0):
    """Save one level's state for exact resume (the JAX signature; its AMR
    arguments raise)."""
    _no_amr(fine_state=fine_state, fine_grid=fine_grid, origin=origin,
            weights=weights, parent_sels=parent_sels, old_fine=old_fine,
            hierarchy=hierarchy)
    write_tree(path, checkpoint_tree(state, level, step, dt, extra,
                                     old_state, cfl))


def _chombo_checkpoint_view(tree, state, level, step, dt, cfl, old_state):
    """The Chombo-layout view of the checkpoint, written into the same
    file beside the native datasets (component names at the root, level
    header attributes, boxes and the new/old velocity, lambda, scalar,
    ccPressure and eLambda LevelDatas), so tooling that reads Chombo
    files reads checkpoints as it reads plot files.  Resume reads the
    native view."""
    grid = level.grid
    ndim = grid.ndim
    nscal = int(state.scalars.shape[0])

    a = tree["attrs"]
    a["num_components"] = np.int32(nscal)
    for c in range(nscal):
        a[f"component_{c}"] = np.bytes_(f"scalar_{c}")
    a["lambda_component"] = np.bytes_("lambda")
    for m in range(ndim):
        a[f"vel_component_{m}"] = np.bytes_(
            f"{'xyz'[m] if ndim == 3 or m < ndim - 1 else 'z'}_vel")
    a["ccPressure_component"] = np.bytes_("ccPressure")
    a["eLambda_component"] = np.bytes_("eLambda")
    tree["Chombo_global"] = {"attrs": {"SpaceDim": np.int32(ndim),
                                       "testReal": np.float64(0.0)}}

    g = tree["level_0"]
    domain_nx = np.asarray(grid.nx, np.int64)
    ga = g["attrs"]
    ga["step_number"] = np.int32(step)
    ga["ref_ratio"] = _as_iv([1] * ndim, ndim)
    ga["vec_dx"] = _as_rv(grid.dx, ndim)
    ga["dt"] = np.float64(float(dt))
    ga["time"] = np.float64(float(state.time))
    ga["cfl"] = np.float64(cfl)
    ga["finest_level"] = np.int32(0)
    ga["is_empty"] = np.int32(0)
    ga["prob_domain"] = _as_box(np.zeros(ndim, np.int64), domain_nx - 1,
                                ndim)
    for d in range(ndim):
        ga[f"is_periodic_{d}"] = np.int32(1 if grid.periodic[d] else 0)
    box = np.empty(1, _box_dtype(ndim))
    box[0] = _as_box(np.zeros(ndim, np.int64), domain_nx - 1, ndim)
    g["boxes"] = box
    g["Processors"] = np.zeros(1, "<i4")

    old = old_state if old_state is not None else state
    vel, ovel = _host(state.vel), _host(old.vel)
    _chombo_leveldata(g, "new_velocity", list(vel), ndim)
    _chombo_leveldata(g, "old_velocity", list(ovel), ndim)
    _chombo_leveldata(g, "new_lambda", [_host(state.lam)], ndim)
    _chombo_leveldata(g, "old_lambda", [_host(old.lam)], ndim)
    scal, oscal = _host(state.scalars), _host(old.scalars)
    for c in range(nscal):
        _chombo_leveldata(g, f"new_scalar_component_{c}", [scal[c]], ndim)
        _chombo_leveldata(g, f"old_scalar_component_{c}", [oscal[c]], ndim)
    _chombo_leveldata(g, "ccPressure", [_host(state.cc_phi)], ndim)
    _chombo_leveldata(g, "eLambda", [_host(state.e_lambda)], ndim)


def state_from_tree(tree: dict, level):
    """(state, step, dt) from a checkpoint tree, on the level's device in
    its dtype."""
    from somar_tpu_torch.physics.navier_stokes import NSState

    grid = level.grid
    kw = dict(dtype=level.params.dtype, device=level.device)
    a = tree["attrs"]
    g = tree["level_0"]
    if tuple(int(n) for n in g["attrs"]["nx"]) != grid.nx:
        raise ValueError(f"checkpoint grid {tuple(g['attrs']['nx'])} != "
                         f"run grid {grid.nx}")

    def t(name):
        return torch.as_tensor(g[name], **kw)

    nscal = level.problem.num_scalars
    state = NSState(
        vel=torch.stack([t(f"new_velocity_{m}") for m in range(grid.ndim)]),
        scalars=torch.stack([t(f"new_scalar_{c}") for c in range(nscal)]),
        lam=t("new_lambda"), mac_phi=t("macPressure"),
        cc_phi=t("ccPressure"), pressure=t("pressure"),
        e_lambda=(t("eLambda") if "eLambda" in g
                  else torch.zeros(grid.shape, **kw)),
        time=torch.tensor(float(a["time"]), **kw))
    return state, int(a["iteration"]), float(a["dt"])


def read_checkpoint(path: str, level, fine_grid=None):
    """Restore (state, step, dt) from a checkpoint of one level."""
    _no_amr(fine_grid=fine_grid)
    return state_from_tree(read_tree(path), level)


# ---------------------------------------------------------------------------
# plot files
# ---------------------------------------------------------------------------
def _plot_fields(state, level, plot_cfg=None) -> dict:
    """Field name -> host array of one level's plot dump, with the
    optional derived fields of the plot.write* flags."""
    from somar_tpu_torch.core.bc import bind_bcs_time
    from somar_tpu_torch.ops.stencil import fc_to_cc, mac_gradient, vorticity
    from somar_tpu_torch.physics.derived import (
        compute_ri_number, compute_stream_function)

    grid = level.grid
    geo = level.geo
    ndim = grid.ndim
    on = (lambda flag: plot_cfg is not None
          and getattr(plot_cfg, flag, False))
    fields = {}
    for m in range(ndim):
        name = "xyz"[m] if m < ndim - 1 or ndim == 3 else "z"
        fields[f"velocity_{name}"] = _host(state.vel[m])
    # with a background split the plotted scalar is the total buoyancy
    # bbar + b'; the deviation is buoyancy_pert
    b = _host(state.scalars[0])
    prob = level.problem
    if prob.use_background_scalar and prob.background is not None:
        z = np.broadcast_to(geo.phys_coords_cc()[ndim - 1], grid.shape)
        b = b + np.asarray(prob.background.value(z)).astype(b.dtype)
    fields["buoyancy"] = b
    if plot_cfg is None or plot_cfg.write_pressure:
        fields["pressure"] = _host(state.pressure)
    if on("write_lambda"):
        fields["lambda"] = _host(state.lam)
    if on("write_divergence"):
        fields["divergence"] = _host(level.cell_divergence(state))
    if on("write_vorticity"):
        w = vorticity(state.vel, geo,
                      bind_bcs_time(level.vel_bcs_trace, state.time))
        if ndim == 2:
            fields["vorticity"] = _host(w)
        else:
            for m in range(3):
                fields[f"vorticity_{'xyz'[m]}"] = _host(w[m])
    if on("write_displacement") and not geo.is_uniform:
        disp = geo.displacement_cc()
        for m in range(ndim):
            fields[f"displacement_{m}"] = disp[m]
    if on("write_geometry") and not geo.is_uniform:
        fields["J"] = _host(geo.J * torch.ones(grid.shape,
                                               dtype=level.params.dtype,
                                               device=level.device))
    if on("write_streamfunction") and ndim == 2:
        fields["streamfunction"] = _host(
            compute_stream_function(level, state))
    if on("write_grad_e_lambda"):
        ge = mac_gradient(state.e_lambda, geo, level.projector.phi_bcs)
        for m in range(ndim):
            fields[f"grad_eLambda_{'xyz'[m]}"] = _host(
                fc_to_cc(ge[m], m, grid))
    if on("write_ri"):
        fields["Ri"] = _host(compute_ri_number(level, state))
    if on("write_scalars_minus_background"):
        fields["buoyancy_pert"] = _host(state.scalars[0])
    if on("write_level_ids"):
        fields["levelIDs"] = np.zeros(grid.shape, np.float32)
    if on("write_proc_ids"):
        # one process owns every cell
        fields["procIDs"] = np.zeros(grid.shape, np.float32)
    return fields


def plotfile_tree(state, level, step: int, plot_cfg=None) -> dict:
    """A simple visualization dump: group level_0 with one dataset per
    plot field."""
    grid = level.grid
    g = {"attrs": {"nx": np.asarray(grid.nx), "dx": np.asarray(grid.dx),
                   "x0": np.asarray(grid.x0)}}
    g.update(_plot_fields(state, level, plot_cfg))
    return {"attrs": {"iteration": step, "time": float(state.time),
                      "ndim": grid.ndim},
            "level_0": g}


def write_plotfile(path: str, state, level, step: int, plot_cfg=None):
    """write_tree of plotfile_tree; for tool-compatible output see
    write_chombo_plotfile."""
    write_tree(path, plotfile_tree(state, level, step, plot_cfg))


# ---------------------------------------------------------------------------
# Chombo-format plot files (VisIt-readable)
# ---------------------------------------------------------------------------
def _iv_dtype(ndim):
    """Chombo HDF5 IntVect compound type (intvecti/j/k)."""
    return np.dtype([(n, "<i4") for n in
                     ["intvecti", "intvectj", "intvectk"][:ndim]])


def _rv_dtype(ndim):
    """Chombo HDF5 RealVect compound type (x/y/z)."""
    return np.dtype([(n, "<f8") for n in "xyz"[:ndim]])


def _box_dtype(ndim):
    """Chombo HDF5 Box compound type (lo_i..hi_k)."""
    names = (["lo_i", "lo_j", "lo_k"][:ndim]
             + ["hi_i", "hi_j", "hi_k"][:ndim])
    return np.dtype([(n, "<i4") for n in names])


def _as_iv(v, ndim):
    out = np.zeros((), _iv_dtype(ndim))
    for i, n in enumerate(out.dtype.names):
        out[n] = int(v[i])
    return out


def _as_rv(v, ndim):
    out = np.zeros((), _rv_dtype(ndim))
    for i, n in enumerate(out.dtype.names):
        out[n] = float(v[i])
    return out


def _as_box(lo, hi, ndim):
    out = np.zeros((), _box_dtype(ndim))
    for i in range(ndim):
        out[out.dtype.names[i]] = int(lo[i])
        out[out.dtype.names[ndim + i]] = int(hi[i])
    return out


def _fab_flat(arrays):
    """One box's per-component arrays in the Chombo FArrayBox layout:
    components outermost, logical dir 0 (x) fastest, float64.  The arrays
    are vertical-major with x last, so a C-order ravel is that layout."""
    return np.concatenate(
        [np.ascontiguousarray(a, dtype=np.float64).ravel(order="C")
         for a in arrays])


def _chombo_leveldata(g, name, comp_arrays, ndim):
    """One Chombo LevelData<FArrayBox> of a single box in group g:
    `<name>:datatype=0` flat doubles, `<name>:offsets=0` box offsets,
    `<name>_attributes` metadata."""
    flat = _fab_flat(comp_arrays)
    g[f"{name}:datatype=0"] = flat
    g[f"{name}:offsets=0"] = np.asarray([0, flat.size], "<i8")
    g[f"{name}_attributes"] = {"attrs": {
        "comps": np.int32(len(comp_arrays)),
        "ghost": _as_iv([0] * ndim, ndim),
        "outputGhost": _as_iv([0] * ndim, ndim),
        "objectType": np.bytes_("FArrayBox")}}


def chombo_plotfile_tree(state, level, step: int, plot_cfg=None,
                         dt: float = 0.0) -> dict:
    """The content of a Chombo-format plot file of one level: root header
    with the component names, level_0 with ref_ratio, vec_dx, dx, dt,
    time, prob_domain, boxes and `data:datatype=0`."""
    grid = level.grid
    ndim = grid.ndim
    fields = _plot_fields(state, level, plot_cfg)
    names = list(fields)
    nx = np.asarray(grid.nx, np.int64)
    root = {"max_level": np.int32(0), "num_levels": np.int32(1),
            "iteration": np.int32(step),
            "time": np.float64(float(state.time)),
            "num_components": np.int32(len(names))}
    for i, name in enumerate(names):
        root[f"component_{i}"] = np.bytes_(name)
    box = np.empty(1, _box_dtype(ndim))
    box[0] = _as_box(np.zeros(ndim, np.int64), nx - 1, ndim)
    level0 = {
        "attrs": {"ref_ratio": _as_iv([1] * ndim, ndim),
                  "vec_dx": _as_rv(grid.dx, ndim),
                  # scalar dx for stock Chombo readers (first dir)
                  "dx": np.float64(grid.dx[0]), "dt": np.float64(dt),
                  "time": np.float64(float(state.time)),
                  "prob_domain": _as_box(np.zeros(ndim, np.int64), nx - 1,
                                         ndim)},
        "boxes": box,
        "data:datatype=0": _fab_flat([fields[n] for n in names]),
        "data_attributes": {"attrs": {
            "comps": np.int32(len(names)),
            "ghost": _as_iv([0] * ndim, ndim),
            "outputGhost": _as_iv([0] * ndim, ndim),
            "objectType": np.bytes_("FArrayBox")}}}
    return {"attrs": root,
            "Chombo_global": {"attrs": {"SpaceDim": np.int32(ndim),
                                        "testReal": np.float64(0.0)}},
            "level_0": level0}


def write_chombo_plotfile(path: str, state, level, step: int, plot_cfg=None,
                          hierarchy=None, fine_states=None, dt: float = 0.0):
    """Write a Chombo-format plot file of one level (the JAX signature;
    its AMR arguments raise)."""
    _no_amr(hierarchy=hierarchy, fine_states=fine_states)
    write_tree(path, chombo_plotfile_tree(state, level, step, plot_cfg, dt))
