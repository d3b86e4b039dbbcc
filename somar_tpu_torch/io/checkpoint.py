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

AMR: with a hierarchy's refined levels (fine_state, their grids, origins
and, where they apply, weights and parent selections, one entry per
refined level), the file holds groups `level_1..level_N` as well, with
the patch_origin / patch_weights / parent_sel attributes and the
datasets of level_0, a leading patch axis on each when the level has
K > 1 patches (attribute num_patches), and the Chombo views carry each
refined level's boxes, one per active patch interior in that level's
global index space.  A resume restores the patches, origins, weights and
parent selections exactly.
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


def _levels(values):
    """A coarse-to-fine list of a per-level argument (a bare value is the
    one refined level's)."""
    if values is None:
        return None
    return list(values) if isinstance(values, (list, tuple)) else [values]


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
def _level_group(state, grid, old_state=None, origin=None, weights=None,
                 parent_sel=None) -> dict:
    g = {"attrs": {"nx": np.asarray(grid.nx), "dx": np.asarray(grid.dx),
                   "x0": np.asarray(grid.x0),
                   "periodic": np.asarray(grid.periodic, dtype=np.int8)}}
    if origin is not None:
        g["attrs"]["patch_origin"] = np.asarray(origin)
    if weights is not None:
        g["attrs"]["patch_weights"] = np.asarray(weights)
    if parent_sel is not None:
        g["attrs"]["parent_sel"] = np.asarray(parent_sel)
    vel, scal = _host(state.vel), _host(state.scalars)
    multi = vel.ndim == grid.ndim + 2       # a leading patch axis
    if multi:
        g["attrs"]["num_patches"] = vel.shape[0]
    comp = (lambda a, i: a[:, i]) if multi else (lambda a, i: a[i])
    for m in range(grid.ndim):
        g[f"new_velocity_{m}"] = comp(vel, m)
    for c in range(scal.shape[1 if multi else 0]):
        g[f"new_scalar_{c}"] = comp(scal, c)
    g["new_lambda"] = _host(state.lam)
    if old_state is not None:
        ovel, oscal = _host(old_state.vel), _host(old_state.scalars)
        for m in range(grid.ndim):
            g[f"old_velocity_{m}"] = comp(ovel, m)
        for c in range(oscal.shape[1 if multi else 0]):
            g[f"old_scalar_{c}"] = comp(oscal, c)
        g["old_lambda"] = _host(old_state.lam)
    g["eLambda"] = _host(state.e_lambda)
    g["ccPressure"] = _host(state.cc_phi)
    g["pressure"] = _host(state.pressure)
    g["macPressure"] = _host(state.mac_phi)
    return g


def checkpoint_tree(state, level, step: int, dt: float,
                    extra: Optional[dict] = None, old_state=None,
                    cfl: float = 0.0, fine_state=None, fine_grid=None,
                    origin=None, weights=None, parent_sels=None,
                    old_fine=None, hierarchy=None) -> dict:
    """The content of a checkpoint of one level's state, or of a
    hierarchy's with fine_state (the refined levels' states), fine_grid
    (their extended patch grids), origin, weights and parent_sels, each
    a coarse-to-fine sequence (or bare with one refined level), for exact
    resume."""
    grid = level.grid
    fines = _levels(fine_state) or []
    nf = len(fines)
    grids = _levels(fine_grid) or [None] * nf
    origins = _levels(origin) or [None] * nf
    wts = _levels(weights) or [None] * nf
    psels = _levels(parent_sels) or [None] * nf
    olds = _levels(old_fine) or [None] * nf
    tree = {"attrs": {"iteration": step, "time": float(state.time),
                      "dt": float(dt), "num_levels": 1 + nf,
                      "ndim": grid.ndim,
                      "config_json": json.dumps(extra or {})},
            "level_0": _level_group(state, grid, old_state)}
    for k in range(nf):
        tree[f"level_{k + 1}"] = _level_group(
            fines[k], grids[k], olds[k], origins[k], wts[k], psels[k])
    _chombo_checkpoint_view(tree, state, level, step, dt, cfl, old_state,
                            fines if hierarchy is not None else [],
                            hierarchy, olds)
    return tree


def write_checkpoint(path: str, state, level, step: int, dt: float,
                     extra: Optional[dict] = None,
                     fine_state=None, fine_grid=None, origin=None,
                     weights=None, parent_sels=None, old_state=None,
                     old_fine=None, hierarchy=None, cfl: float = 0.0):
    """Save one level's state, or a hierarchy's, for exact resume (the
    JAX signature)."""
    write_tree(path, checkpoint_tree(
        state, level, step, dt, extra, old_state, cfl, fine_state,
        fine_grid, origin, weights, parent_sels, old_fine, hierarchy))


def _chombo_checkpoint_view(tree, state, level, step, dt, cfl, old_state,
                            fine_states=(), hierarchy=None, old_fine=()):
    """The Chombo-layout view of the checkpoint, written into the same
    file beside the native datasets (component names at the root, level
    header attributes, boxes and the new/old velocity, lambda, scalar,
    ccPressure and eLambda LevelDatas; a refined level one box per active
    patch interior), so tooling that reads Chombo files reads checkpoints
    as it reads plot files.  Resume reads the native view."""
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

    fs = list(fine_states)
    nlev = 1 + len(fs)
    domain_nx = np.asarray(grid.nx, np.int64)
    lev_dt = float(dt)
    for ilev in range(nlev):
        g = tree[f"level_{ilev}"]
        if ilev == 0:
            st, old = state, old_state
            boxes = [(np.zeros(ndim, np.int64), domain_nx - 1,
                      (slice(None),) * ndim)]
            patch_ids = [None]
            dx = grid.dx
            rr = (list(hierarchy.couplings[0].ratio[:ndim])
                  if hierarchy is not None and hierarchy.couplings
                  else [1] * ndim)
            t = float(state.time)
        else:
            c = hierarchy.couplings[ilev - 1]
            st, old = fs[ilev - 1], old_fine[ilev - 1]
            domain_nx = domain_nx * np.asarray(c.ratio[:ndim], np.int64)
            boxes, patch_ids = _fine_level_boxes(hierarchy, ilev - 1, c,
                                                 domain_nx)
            if c.K == 1:
                patch_ids = [None]
            dx = c.ext_grid.dx
            rr = (list(hierarchy.couplings[ilev].ratio[:ndim])
                  if ilev < len(hierarchy.couplings) else [1] * ndim)
            lev_dt /= c.nt
            t = float(_host(st.time).ravel()[0])
        ga = g["attrs"]
        ga["step_number"] = np.int32(step)
        ga["ref_ratio"] = _as_iv(rr, ndim)
        ga["vec_dx"] = _as_rv(dx, ndim)
        ga["dt"] = np.float64(lev_dt)
        ga["time"] = np.float64(t)
        ga["cfl"] = np.float64(cfl)
        ga["finest_level"] = np.int32(nlev - 1)
        ga["is_empty"] = np.int32(0)
        ga["prob_domain"] = _as_box(np.zeros(ndim, np.int64), domain_nx - 1,
                                    ndim)
        for d in range(ndim):
            ga[f"is_periodic_{d}"] = np.int32(1 if grid.periodic[d] else 0)
        recs = np.empty(len(boxes), _box_dtype(ndim))
        for b, (lo, hi, _) in enumerate(boxes):
            recs[b] = _as_box(lo, hi, ndim)
        g["boxes"] = recs
        g["Processors"] = np.zeros(len(boxes), "<i4")

        old = old if old is not None else st

        def boxed(field, ncomp):
            """Per box, the component arrays of a (maybe patch-stacked)
            field, cut to the box."""
            a_ = _host(field)
            out = []
            for (_, _, sl), k in zip(boxes, patch_ids):
                ak = a_ if k is None else a_[k]
                comps = [ak[m] for m in range(ncomp)] if ncomp > 1 else [ak]
                out.append([x[sl] for x in comps])
            return out

        _chombo_leveldata(g, "new_velocity", boxed(st.vel, ndim), ndim)
        _chombo_leveldata(g, "old_velocity", boxed(old.vel, ndim), ndim)
        _chombo_leveldata(g, "new_lambda", boxed(st.lam, 1), ndim)
        _chombo_leveldata(g, "old_lambda", boxed(old.lam, 1), ndim)
        multi = st.scalars.ndim == ndim + 2
        for c_ in range(nscal):
            sel = (lambda f: f[:, c_]) if multi else (lambda f: f[c_])
            _chombo_leveldata(g, f"new_scalar_component_{c_}",
                              boxed(sel(st.scalars), 1), ndim)
            _chombo_leveldata(g, f"old_scalar_component_{c_}",
                              boxed(sel(old.scalars), 1), ndim)
        _chombo_leveldata(g, "ccPressure", boxed(st.cc_phi, 1), ndim)
        _chombo_leveldata(g, "eLambda", boxed(st.e_lambda, 1), ndim)


def _state_from_group(g, grid, time: float, nscal: int, kw) -> "NSState":
    from somar_tpu_torch.physics.navier_stokes import NSState

    multi = "num_patches" in g["attrs"]
    ax = 1 if multi else 0

    def t(name):
        return torch.as_tensor(g[name], **kw)

    e_lam = (t("eLambda") if "eLambda" in g
             else torch.zeros(grid.shape, **kw))
    return NSState(
        vel=torch.stack([t(f"new_velocity_{m}") for m in range(grid.ndim)],
                        dim=ax),
        scalars=torch.stack([t(f"new_scalar_{c}") for c in range(nscal)],
                            dim=ax),
        lam=t("new_lambda"), mac_phi=t("macPressure"),
        cc_phi=t("ccPressure"), pressure=t("pressure"), e_lambda=e_lam,
        time=(torch.full((int(g["attrs"]["num_patches"]),), time, **kw)
              if multi else torch.tensor(time, **kw)))


def state_from_tree(tree: dict, level, fine_grid=None):
    """(state, step, dt) from a checkpoint tree, on the level's device in
    its dtype.  With fine_grid (the refined levels' extended grids) and a
    level_1 group in the tree: (state, step, dt, fine_state, origin) for
    a bare fine_grid, (state, step, dt, fine_states, origins, weights,
    parent_sels) tuples, one entry per refined level, for a sequence."""
    grid = level.grid
    kw = dict(dtype=level.params.dtype, device=level.device)
    a = tree["attrs"]
    g = tree["level_0"]
    if tuple(int(n) for n in g["attrs"]["nx"]) != grid.nx:
        raise ValueError(f"checkpoint grid {tuple(g['attrs']['nx'])} != "
                         f"run grid {grid.nx}")
    time = float(a["time"])
    nscal = level.problem.num_scalars
    state = _state_from_group(g, grid, time, nscal, kw)
    step, dt = int(a["iteration"]), float(a["dt"])
    if fine_grid is None or "level_1" not in tree:
        return state, step, dt
    single = not isinstance(fine_grid, (list, tuple))
    grids = _levels(fine_grid)
    fines, origins, weights, psels = [], [], [], []
    for k, gk in enumerate(grids):
        g1 = tree[f"level_{k + 1}"]
        at = g1["attrs"]
        fines.append(_state_from_group(g1, gk, time, nscal, kw))
        origins.append(np.asarray(at["patch_origin"]))
        weights.append(np.asarray(at["patch_weights"])
                       if "patch_weights" in at else None)
        psels.append(np.asarray(at["parent_sel"])
                     if "parent_sel" in at else None)
    if single:
        return state, step, dt, fines[0], origins[0]
    return (state, step, dt, tuple(fines), tuple(origins), tuple(weights),
            tuple(psels))


def read_checkpoint(path: str, level, fine_grid=None):
    """Restore (state, step, dt) from a checkpoint, and the refined
    levels' patches, origins, weights and parent selections when
    fine_grid is given (state_from_tree)."""
    return state_from_tree(read_tree(path), level, fine_grid)


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


def _chombo_leveldata(g, name, per_box_comp_arrays, ndim):
    """One Chombo LevelData<FArrayBox> in group g: `<name>:datatype=0`
    flat doubles of every box in turn, `<name>:offsets=0` the boxes'
    offsets, `<name>_attributes` metadata.  per_box_comp_arrays: per box,
    its per-component arrays."""
    flats = [_fab_flat(arrays) for arrays in per_box_comp_arrays]
    offsets = np.cumsum([0] + [f.size for f in flats])
    g[f"{name}:datatype=0"] = (np.concatenate(flats) if flats
                               else np.zeros(0, np.float64))
    g[f"{name}:offsets=0"] = np.asarray(offsets, "<i8")
    g[f"{name}_attributes"] = {"attrs": {
        "comps": np.int32(len(per_box_comp_arrays[0])
                          if per_box_comp_arrays else 0),
        "ghost": _as_iv([0] * ndim, ndim),
        "outputGhost": _as_iv([0] * ndim, ndim),
        "objectType": np.bytes_("FArrayBox")}}


def _fine_level_boxes(hierarchy, lev, c, domain_nx):
    """The active patch interiors of refined level `lev` as boxes in that
    level's 0-based global index space: ([(lo per logical dir, hi per
    logical dir, interior slices into the extended array)], [patch
    index])."""
    ndim = c.ext_grid.ndim
    los, patch_ids = [], []
    if c.K > 1:
        for k in range(c.K):
            if c.weights is not None and float(c.weights[k]) == 0.0:
                continue
            los.append(hierarchy._global_origin(
                lev, last_origin=c.origin_f[k], patch=k))
            patch_ids.append(k)
    else:
        los.append(hierarchy._global_origin(lev))
        patch_ids.append(0)
    int_start = tuple(c.halo if c.ext_grid.dir_of_axis(ax) in c.cf_dirs
                      else 0 for ax in range(ndim))
    boxes = []
    for g in los:
        lo_d = np.zeros(ndim, np.int64)
        hi_d = np.zeros(ndim, np.int64)
        sl = []
        for ax in range(ndim):
            d = c.ext_grid.dir_of_axis(ax)
            lo_d[d] = g[ax] + int_start[ax]
            hi_d[d] = lo_d[d] + c.interior_nx[d] - 1
            sl.append(slice(int_start[ax], int_start[ax] + c.interior_nx[d]))
        boxes.append((lo_d, hi_d, tuple(sl)))
    return boxes, patch_ids


def _data_attributes(ncomp, ndim):
    return {"attrs": {"comps": np.int32(ncomp),
                      "ghost": _as_iv([0] * ndim, ndim),
                      "outputGhost": _as_iv([0] * ndim, ndim),
                      "objectType": np.bytes_("FArrayBox")}}


def chombo_plotfile_tree(state, level, step: int, plot_cfg=None,
                         dt: float = 0.0, hierarchy=None,
                         fine_states=None) -> dict:
    """The content of a Chombo-format plot file: root header with the
    component names, then per level ref_ratio, vec_dx, dx, dt, time,
    prob_domain, boxes and `data:datatype=0`.  With a hierarchy and its
    refined levels' states (a coarse-to-fine sequence, or bare with one
    refined level), level_l holds one box per active patch interior of
    refined level l in its global index space, at the level's dt (dt over
    the product of the subcycle counts above it)."""
    grid = level.grid
    ndim = grid.ndim
    fields0 = _plot_fields(state, level, plot_cfg)
    names = list(fields0)
    nx = np.asarray(grid.nx, np.int64)
    # per level: (per-box field dicts, boxes, dx, domain, ref_ratio, dt)
    levels = [([fields0], [(np.zeros(ndim, np.int64), nx - 1,
                            (slice(None),) * ndim)],
               grid.dx, nx, [1] * ndim, float(dt))]
    fs = _levels(fine_states) if hierarchy is not None else None
    if fs:
        from somar_tpu_torch.amr.hierarchy import tree_index
        dom, lev_dt = nx, float(dt)
        for lev, c in enumerate(hierarchy.couplings):
            dom = dom * np.asarray(c.ratio[:ndim], np.int64)
            lev_dt /= c.nt
            boxes, ids = _fine_level_boxes(hierarchy, lev, c, dom)
            # each patch with its own metric (a mapped slot's map view)
            per_box = [_plot_fields(fs[lev] if c.K == 1 else
                                    tree_index(fs[lev], k), c.map_level(k),
                                    plot_cfg)
                       for k in ids]
            levels[-1] = levels[-1][:4] + (list(c.ratio[:ndim]),
                                           levels[-1][5])
            levels.append((per_box, boxes, c.ext_grid.dx, dom, [1] * ndim,
                           lev_dt))
    root = {"max_level": np.int32(len(levels) - 1),
            "num_levels": np.int32(len(levels)),
            "iteration": np.int32(step),
            "time": np.float64(float(state.time)),
            "num_components": np.int32(len(names))}
    for i, name in enumerate(names):
        root[f"component_{i}"] = np.bytes_(name)
    tree = {"attrs": root,
            "Chombo_global": {"attrs": {"SpaceDim": np.int32(ndim),
                                        "testReal": np.float64(0.0)}}}
    for ilev, (per_box, boxes, dx, dom, rr, lev_dt) in enumerate(levels):
        recs = np.empty(len(boxes), _box_dtype(ndim))
        flat = []
        for b, (lo, hi, sl) in enumerate(boxes):
            recs[b] = _as_box(lo, hi, ndim)
            fb = per_box[b]
            flat.append(_fab_flat([fb[n][sl] for n in names]))
        tree[f"level_{ilev}"] = {
            "attrs": {"ref_ratio": _as_iv(rr, ndim),
                      "vec_dx": _as_rv(dx, ndim),
                      # scalar dx for stock Chombo readers (first dir)
                      "dx": np.float64(dx[0]), "dt": np.float64(lev_dt),
                      "time": np.float64(float(state.time)),
                      "prob_domain": _as_box(np.zeros(ndim, np.int64),
                                             dom - 1, ndim)},
            "boxes": recs,
            "data:datatype=0": (np.concatenate(flat) if flat
                                else np.zeros(0)),
            "data_attributes": _data_attributes(len(names), ndim)}
    return tree


def write_chombo_plotfile(path: str, state, level, step: int, plot_cfg=None,
                          hierarchy=None, fine_states=None, dt: float = 0.0):
    """Write a Chombo-format plot file (the JAX signature): one level, or
    with hierarchy and fine_states every refined level's patch interiors
    too."""
    write_tree(path, chombo_plotfile_tree(state, level, step, plot_cfg, dt,
                                          hierarchy, fine_states))
