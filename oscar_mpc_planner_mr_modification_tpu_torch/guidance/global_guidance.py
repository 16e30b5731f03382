"""Global guidance: Visibility-PRM search in (x, y, t) with homotopy classes.

Counterpart of the JAX package's ``guidance/global_guidance.py`` (the role of
the external ``guidance_planner`` package): sample a space-time roadmap between
the robot and a grid of goals, enumerate time-monotone collision-free paths,
classify them into homotopy classes (:mod:`.homotopy`), smooth each class
representative with cubic splines, and select up to ``n_paths`` distinct classes
with a consistency-weighted heuristic.

Host code: the search is tiny (default 30 samples, horizon 6 s); the
per-class MPC solves are the batched GPU part. The candidate search runs in
C++ (``native/prm.cpp`` through :mod:`.cpp_backend`, backend ``"cpp"``) or
in numpy (``"python"``); ``"auto"`` takes C++ when it builds.
``ran_backend`` records which one the last ``update`` ran. The H-signature
that classifies paths (``comparison_function="Homology"``) runs in C++
unless the backend is ``"python"`` or ``"auto"`` and the library does not
build, as the JAX package decides it; the choice is made once, when the
object is built, and ``signature_backend`` records it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .homotopy import (make_comparators, same_homotopy_class,
                       signature_vector)
from ..ops.spline_fit import natural_cubic_coeffs

TOPOLOGY_NO_MATCH = -999


@dataclass
class Goal:
    pos: np.ndarray  # (2,)
    cost: float


@dataclass
class GuidanceTrajectory:
    positions: np.ndarray  # (N+1, 2) sampled at dt
    velocities: np.ndarray  # (N+1, 2)
    topology_class: int
    signature: np.ndarray
    cost: float
    previously_selected: bool = False
    color: int = 0


@dataclass
class GuidanceConfig:
    N: int = 30
    dt: float = 0.2
    n_paths: int = 4
    n_samples: int = 30
    seed: int = 1
    max_velocity: float = 3.0
    max_acceleration: float = 7.0
    longitudinal_goals: int = 3
    vertical_goals: int = 3
    selection_weight_consistency: float = 0.75
    selection_weight_length: float = 5.0
    max_paths_to_enumerate: int = 200
    pass_threshold: float = np.pi  # winding-difference class threshold
    # Homotopy comparison function: "Winding" or "Homology" (H-signature),
    # the guidance_planner's comparison_function option
    # (config/guidance_planner.yaml:12-16; its default is Homology, ours is
    # Winding - the two agree on clear-cut passing sides, and Winding is
    # cheaper).
    comparison_function: str = "Winding"


class GlobalGuidance:
    def __init__(self, config: Optional[GuidanceConfig] = None,
                 backend: str = "auto"):
        """backend: "python" (portable reference), "cpp" (native PRM via
        ctypes, guidance/cpp_backend.py), or "auto" (cpp when buildable)."""
        from . import cpp_backend

        if backend not in ("python", "cpp", "auto"):
            raise ValueError(f"unknown guidance backend {backend!r}")
        self.config = config or GuidanceConfig()
        homology = self.config.comparison_function.lower() != "winding"
        # "cpp", "python": what classifies paths, fixed for this object
        self.signature_backend = (
            "cpp" if homology and (backend == "cpp" or cpp_backend.available())
            else "python")
        (self._signature, self._signature_batch,
         self._class_threshold) = make_comparators(
            self.config.comparison_function, self.config.dt,
            self.config.pass_threshold, backend=self.signature_backend)
        self.backend = backend
        self.ran_backend = None  # "cpp" or "python": what the last update ran
        self.rng = np.random.default_rng(
            self.config.seed if self.config.seed >= 0 else None)
        # Inputs per cycle
        self._start = np.zeros(2)
        self._start_velocity = np.zeros(2)
        self._goals: List[Goal] = []
        self._obstacle_trajs = np.zeros((0, self.config.N + 1, 2))
        self._obstacle_radii = np.zeros(0)
        self._static_halfspaces: List = []
        # Outputs
        self.trajectories: List[GuidanceTrajectory] = []
        # Cross-cycle consistency bookkeeping
        self._selected_class: int = -1
        self._selected_path: Optional[np.ndarray] = None
        self._class_counter: int = 0
        self._known_classes: List = []  # (class_id, representative path (N+1,2))

    # -- inputs ------------------------------------------------------------
    def set_start(self, position, orientation: float, velocity: float) -> None:
        self._start = np.asarray(position, dtype=float)
        self._start_velocity = velocity * np.array(
            [np.cos(orientation), np.sin(orientation)])

    def set_goals(self, goals: List[Goal]) -> None:
        self._goals = goals

    def load_obstacles(self, trajectories, radii) -> None:
        """trajectories: (n_obs, >=N+1, 2) predicted positions on the dt grid."""
        self._obstacle_trajs = np.asarray(trajectories, dtype=float)
        self._obstacle_radii = np.asarray(radii, dtype=float)

    def load_static_obstacles(self, halfspaces) -> None:
        self._static_halfspaces = list(halfspaces)

    def load_reference_path(self, s_start: float, path, width_left: float,
                            width_right: float, path_velocity=None,
                            reference_velocity: float = 2.0) -> None:
        """Goal grid along the path (guidance_constraints.cpp:131-206): integrate
        the path velocity to the horizon end, grid n_long x n_lat goals orthogonal
        to the path with a center-line bias."""
        cfg = self.config
        if path_velocity is None:
            final_s = s_start + reference_velocity * cfg.dt * (cfg.N - 1)
        else:
            final_s = s_start
            for _ in range(1, cfg.N):
                final_s += path_velocity(final_s) * cfg.dt
        n_long, n_lat = cfg.longitudinal_goals, cfg.vertical_goals
        assert n_lat % 2 == 1, "Number of lateral grid points should be odd!"
        assert n_long >= 2, "At least two longitudinal goals required"
        middle_lat = (n_lat - 1) // 2
        s_long = np.linspace(s_start, final_s, n_long)
        long_best = s_long[-1]
        # One vectorized spline pass for all longitudinal stations
        points = path.at(s_long)  # (n_long, 2)
        tangents = path.deriv(s_long)
        tangents = tangents / (
            np.linalg.norm(tangents, axis=1, keepdims=True) + 1e-12)
        normals = np.stack([tangents[:, 1], -tangents[:, 0]], axis=1)
        dist_lat = np.linspace(-width_left, width_right, n_lat)
        dist_lat[middle_lat] = 0.0
        goals: List[Goal] = []
        for i, s in enumerate(s_long):
            long_cost = abs(s - long_best)
            for j, d in enumerate(dist_lat):
                if i == 0 and j != middle_lat:
                    continue
                goals.append(Goal(points[i] + normals[i] * d,
                                  long_cost + abs(d)))
        self._goals = goals

    # -- collision helpers -------------------------------------------------
    def _obstacle_pos_at(self, t: float) -> np.ndarray:
        """(n_obs, 2) interpolated obstacle positions at continuous time t."""
        if len(self._obstacle_trajs) == 0:
            return np.zeros((0, 2))
        cfg = self.config
        k = t / cfg.dt
        k0 = int(np.clip(np.floor(k), 0, self._obstacle_trajs.shape[1] - 1))
        k1 = min(k0 + 1, self._obstacle_trajs.shape[1] - 1)
        alpha = np.clip(k - k0, 0.0, 1.0)
        return ((1 - alpha) * self._obstacle_trajs[:, k0]
                + alpha * self._obstacle_trajs[:, k1])

    def _point_free(self, pos: np.ndarray, t: float, margin: float = 0.0) -> bool:
        obs = self._obstacle_pos_at(t)
        if len(obs):
            d = np.linalg.norm(obs - pos[None, :], axis=1)
            if np.any(d < self._obstacle_radii + margin):
                return False
        for hs in self._static_halfspaces:
            if float(np.dot(hs.A, pos)) > hs.b:
                return False
        return True

    def _points_free_batch(self, pos: np.ndarray, t: np.ndarray,
                           margin: float = 0.0) -> np.ndarray:
        """Vectorized :meth:`_point_free` over M (pos, t) pairs -> (M,) bool.
        Identical math (same interpolation and distance formulas)."""
        M = pos.shape[0]
        free = np.ones(M, dtype=bool)
        if len(self._obstacle_trajs):
            cfg = self.config
            K = self._obstacle_trajs.shape[1]
            k = t / cfg.dt
            k0 = np.clip(np.floor(k), 0, K - 1).astype(int)
            k1 = np.minimum(k0 + 1, K - 1)
            alpha = np.clip(k - k0, 0.0, 1.0)
            # (M, n_obs, 2) interpolated obstacle positions
            obs = ((1 - alpha)[:, None, None]
                   * self._obstacle_trajs[:, k0].transpose(1, 0, 2)
                   + alpha[:, None, None]
                   * self._obstacle_trajs[:, k1].transpose(1, 0, 2))
            d = np.linalg.norm(obs - pos[:, None, :], axis=2)
            free &= ~np.any(d < self._obstacle_radii[None] + margin, axis=1)
        for hs in self._static_halfspaces:
            free &= ~(pos @ np.asarray(hs.A) > hs.b)
        return free

    def _build_adjacency(self, nodes) -> List[List[int]]:
        """Time-monotone visibility DAG over all node pairs, vectorized.

        Pairs are grouped by their segment check count so the sampled check
        points (and therefore the accept/reject decisions) are IDENTICAL to
        the scalar :meth:`_segment_valid` — this is a pure speedup of the
        O(n^2) construction that dominated the Python PRM's runtime."""
        n = len(nodes)
        Pn = np.array([nd[0] for nd in nodes])
        Tn = np.array([nd[1] for nd in nodes])
        iu, ju = np.triu_indices(n, k=1)
        dtij = Tn[ju] - Tn[iu]
        ok = dtij > 1e-9
        dist = np.linalg.norm(Pn[ju] - Pn[iu], axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ok &= np.where(ok, dist / np.maximum(dtij, 1e-12)
                           <= self.config.max_velocity, False)
        n_checks = np.maximum(
            2, np.ceil(dtij / (self.config.dt * 0.5)).astype(int))
        for kc in np.unique(n_checks[ok]):
            idx = np.nonzero(ok & (n_checks == kc))[0]
            if not len(idx):
                continue
            alphas = np.linspace(0.0, 1.0, kc + 1)
            seg = (Pn[ju[idx]] - Pn[iu[idx]])  # (q, 2)
            pts = (Pn[iu[idx]][:, None, :]
                   + alphas[None, :, None] * seg[:, None, :])  # (q, kc+1, 2)
            ts = Tn[iu[idx]][:, None] + alphas[None, :] * dtij[idx][:, None]
            free = self._points_free_batch(
                pts.reshape(-1, 2), ts.reshape(-1)).reshape(len(idx), kc + 1)
            ok[idx[~free.all(axis=1)]] = False
        adj: List[List[int]] = [[] for _ in range(n)]
        for i, j, o in zip(iu, ju, ok):
            if o:
                adj[i].append(int(j))
        return adj

    def _segment_valid(self, p1, t1, p2, t2, margin: float = 0.0) -> bool:
        """Time-monotone, velocity-limited, collision-free straight connection."""
        if t2 <= t1 + 1e-9:
            return False
        v = np.linalg.norm(p2 - p1) / (t2 - t1)
        if v > self.config.max_velocity:
            return False
        n_checks = max(2, int(np.ceil((t2 - t1) / (self.config.dt * 0.5))))
        for alpha in np.linspace(0.0, 1.0, n_checks + 1):
            pos = p1 + alpha * (p2 - p1)
            if not self._point_free(pos, t1 + alpha * (t2 - t1), margin):
                return False
        return True

    # -- the PRM update ----------------------------------------------------
    def update(self) -> bool:
        """Run the Visibility-PRM search and extract homotopy-distinct guidance
        trajectories. Returns True if at least one was found."""
        if self.backend in ("cpp", "auto"):
            from . import cpp_backend

            if cpp_backend.available():
                return self._update_native(cpp_backend)
            if self.backend == "cpp":
                raise RuntimeError("native PRM backend requested but unavailable")
        return self._update_python()

    def _update_native(self, cpp_backend) -> bool:
        """Candidate generation in C++ (native/prm.cpp); selection, smoothing
        and cross-cycle class bookkeeping stay identical to the Python path."""
        cfg = self.config
        self.ran_backend = "cpp"
        self._prev_trajectories = self.trajectories  # cycle-to-cycle id source
        self.trajectories = []
        if not self._goals:
            return False
        goals = np.array([[g.pos[0], g.pos[1], g.cost] for g in self._goals])
        obs = self._obstacle_trajs[:, : cfg.N + 1] if len(
            self._obstacle_trajs) else np.zeros((0, cfg.N + 1, 2))
        paths, sigs, costs = cpp_backend.prm_search(
            self._start, goals, obs, self._obstacle_radii, cfg.dt, cfg.N + 1,
            cfg.n_samples,
            seed=(self.config.seed if self.config.seed >= 0
                  else int(self.rng.integers(0, 2**63))),
            max_velocity=cfg.max_velocity,
            length_weight=cfg.selection_weight_length,
            pass_threshold=cfg.pass_threshold,
            max_paths_enum=cfg.max_paths_to_enumerate,
            n_out=cfg.n_paths)
        # Signatures are recomputed with the CONFIGURED comparator inside
        # _finalize_candidates: the native search returns winding signatures
        # for its internal pre-dedup; under comparison_function="Homology"
        # those values would be compared against the H-signature threshold,
        # and every guidance trajectory would get a fresh class id.
        return self._finalize_candidates(
            [(costs[i], paths[i]) for i in range(len(paths))])

    def _update_python(self) -> bool:
        cfg = self.config
        self.ran_backend = "python"
        T_horizon = cfg.N * cfg.dt
        self._prev_trajectories = self.trajectories  # cycle-to-cycle id source
        self.trajectories = []
        if not self._goals:
            return False

        # Node set: start (t=0), goals (t=T), free samples in between
        nodes = [(self._start, 0.0, "start", 0.0)]
        for g in self._goals:
            if self._point_free(g.pos, T_horizon):
                nodes.append((g.pos, T_horizon, "goal", g.cost))
        if len(nodes) == 1:
            return False

        lo = np.minimum(self._start, np.min([g.pos for g in self._goals], axis=0))
        hi = np.maximum(self._start, np.max([g.pos for g in self._goals], axis=0))
        span = np.maximum(hi - lo, 1.0)
        lo -= 0.25 * span
        hi += 0.25 * span

        n_sampled = 0
        attempts = 0
        while n_sampled < cfg.n_samples and attempts < cfg.n_samples * 10:
            attempts += 1
            t = self.rng.uniform(0.15, 0.85) * T_horizon
            pos = self.rng.uniform(lo, hi)
            if self._point_free(pos, t):
                nodes.append((pos, t, "sample", 0.0))
                n_sampled += 1

        # Sort by time; build the time-monotone visibility DAG
        order = np.argsort([n[1] for n in nodes], kind="stable")
        nodes = [nodes[i] for i in order]
        n = len(nodes)
        start_idx = next(i for i, nd in enumerate(nodes) if nd[2] == "start")
        goal_idx = [i for i, nd in enumerate(nodes) if nd[2] == "goal"]
        adj = self._build_adjacency(nodes)

        # Enumerate start->goal paths (bounded DFS over the DAG)
        paths: List[List[int]] = []

        def dfs(i, current):
            if len(paths) >= cfg.max_paths_to_enumerate:
                return
            if nodes[i][2] == "goal":
                paths.append(list(current))
                return
            for j in adj[i]:
                current.append(j)
                dfs(j, current)
                current.pop()

        dfs(start_idx, [start_idx])
        if not paths:
            return False

        # Sample every path on the dt grid; classification/dedup/cost ranking
        # happen batched in _finalize_candidates
        candidates = []
        for path in paths:
            pts = np.array([nodes[i][0] for i in path])
            ts = np.array([nodes[i][1] for i in path])
            sampled = self._resample(pts, ts)
            goal_cost = nodes[path[-1]][3]
            length = float(np.sum(np.linalg.norm(np.diff(pts, axis=0), axis=1)))
            cost = goal_cost + cfg.selection_weight_length * length
            candidates.append((cost, sampled))
        return self._finalize_candidates(candidates)

    def _finalize_candidates(self, candidates) -> bool:
        """Class dedup, smoothing, consistency flags and stable class ids -
        shared by the Python and native candidate generators.

        ``candidates``: list of ``(cost, sampled_path (N+1, 2))``. ALL
        per-tick signatures (candidates, the previously selected path, last
        cycle's representatives) are computed in ONE vectorized batch — the
        per-path H-signature is ~1 ms of host numpy and this runs inside the
        runtime tick whose p99 budget is 33 ms."""
        cfg = self.config
        obs = self._obstacle_trajs[:, : cfg.N + 1]

        prev_traj_list = list(getattr(self, "_prev_trajectories", []))
        has_prev_sel = (self._selected_path is not None
                        and self._selected_class >= 0)
        stack = [np.asarray(c[1], dtype=float) for c in candidates]
        stack += [np.asarray(t.positions, dtype=float) for t in prev_traj_list]
        if has_prev_sel:
            stack.append(np.asarray(self._selected_path, dtype=float))

        if stack and all(p.shape == stack[0].shape for p in stack):
            sigs = list(self._signature_batch(np.stack(stack), obs))
        else:  # mixed-length paths (not produced by the shipped generators)
            sigs = [self._signature(p, obs) for p in stack]

        n_cand = len(candidates)
        candidates = sorted(
            ((c[0], c[1], sigs[i]) for i, c in enumerate(candidates)),
            key=lambda c: c[0])

        # Previously selected path: signature recomputed on current obstacles
        prev_sig = sigs[-1] if has_prev_sel else None

        # Cycle-to-cycle id propagation sources: LAST cycle's chosen
        # trajectories, re-evaluated on the CURRENT obstacle predictions.
        # They are one control period stale (start ~v*dt behind the new
        # candidates), so class matching is reliable — matching multi-tick-old
        # world-frame representatives instead allocates a fresh id nearly
        # every cycle during robot-robot interactions, firing the
        # TOPOLOGY_CHANGE communication trigger on every tick (the
        # guidance_planner likewise propagates spline ids between
        # consecutive cycles).
        prev_cycle = [
            (t.topology_class, sigs[n_cand + i])
            for i, t in enumerate(prev_traj_list)]

        chosen: List[GuidanceTrajectory] = []
        chosen_raw: List[np.ndarray] = []
        used_ids: set = set()
        for cost, sampled, sig in candidates:
            if any(same_homotopy_class(sig, c.signature,
                                       self._class_threshold)
                   for c in chosen):
                continue
            previously_selected = (
                prev_sig is not None
                and same_homotopy_class(sig, prev_sig,
                                        self._class_threshold))
            class_id = self._assign_class_id(sig, previously_selected,
                                             prev_cycle, used_ids)
            used_ids.add(class_id)
            chosen_raw.append(np.asarray(sampled, dtype=float))
            chosen.append(GuidanceTrajectory(
                positions=None, velocities=None, topology_class=class_id,
                signature=sig, cost=cost,
                previously_selected=previously_selected,
                color=len(chosen)))
            if len(chosen) >= cfg.n_paths:
                break

        # Smooth all selected trajectories in one batched fit
        if chosen:
            smoothed = self._smooth_batch(np.stack(chosen_raw))
            vels = np.gradient(smoothed, cfg.dt, axis=1)
            for t, p, v in zip(chosen, smoothed, vels):
                t.positions, t.velocities = p, v

        # Previously-selected class first (guidance_planner orders by selection)
        chosen.sort(key=lambda t: (not t.previously_selected, t.cost))
        self.trajectories = chosen
        return len(chosen) > 0

    def _resample(self, pts: np.ndarray, ts: np.ndarray) -> np.ndarray:
        cfg = self.config
        t_grid = np.arange(cfg.N + 1) * cfg.dt
        x = np.interp(t_grid, ts, pts[:, 0])
        y = np.interp(t_grid, ts, pts[:, 1])
        return np.stack([x, y], axis=1)

    def _smooth(self, sampled: np.ndarray) -> np.ndarray:
        """Cubic-spline smoothing through a subset of knots (the guidance
        planner's spline optimization stage, simplified)."""
        return self._smooth_batch(np.asarray(sampled, dtype=float)[None])[0]

    def _smooth_batch(self, sampled: np.ndarray) -> np.ndarray:
        """:meth:`_smooth` for a (P, N+1, 2) stack in one tridiagonal solve
        (every selected trajectory is smoothed each control tick)."""
        cfg = self.config
        t_grid = np.arange(cfg.N + 1) * cfg.dt
        n_knots = min(8, sampled.shape[1])
        knot_idx = np.unique(np.linspace(0, cfg.N, n_knots).astype(int))
        tk = t_grid[knot_idx]
        # (n_knots, P, 2) so the knot axis leads for the batched cubic fit
        y = sampled[:, knot_idx].transpose(1, 0, 2)
        a, b, c, dd = natural_cubic_coeffs(tk, y)  # each (n_seg, P, 2)
        seg = np.clip(np.searchsorted(tk, t_grid, side="right") - 1, 0,
                      len(a) - 1)
        ds = (t_grid - tk[seg])[:, None, None]
        out = ((a[seg] * ds + b[seg]) * ds + c[seg]) * ds + dd[seg]
        out = out.transpose(1, 0, 2)  # back to (P, N+1, 2)
        return out

    def _assign_class_id(self, sig: np.ndarray, previously_selected: bool,
                         prev_cycle=(), used_ids=frozenset()) -> int:
        if (previously_selected and self._selected_class >= 0
                and self._selected_class not in used_ids):
            return self._selected_class
        # Cycle-to-cycle propagation: inherit the id of last cycle's
        # trajectory in the same class (one-tick staleness)
        for class_id, rep_sig in prev_cycle:
            if class_id in used_ids:
                continue
            if same_homotopy_class(sig, rep_sig, self._class_threshold):
                return class_id
        # Fallback: multi-tick representative store (classes that skipped a
        # few cycles), newest first
        for class_id, rep_path in reversed(self._known_classes):
            if class_id in used_ids:
                continue
            rep_sig = self._signature(
                rep_path, self._obstacle_trajs[:, : self.config.N + 1])
            if same_homotopy_class(sig, rep_sig, self._class_threshold):
                return class_id
        class_id = self._class_counter
        self._class_counter += 1
        return class_id

    # -- outputs + cross-cycle API ----------------------------------------
    def succeeded(self) -> bool:
        return len(self.trajectories) > 0

    def number_of_guidance_trajectories(self) -> int:
        return len(self.trajectories)

    def get_guidance_trajectory(self, i: int) -> GuidanceTrajectory:
        return self.trajectories[i]

    def find_topology_class_for_path(self, path_xy: np.ndarray,
                                     trajectories=None,
                                     obstacle_trajs=None) -> int:
        """Classify an arbitrary (N+1, 2) trajectory against the current guidance
        trajectories (guidance_constraints.cpp:448-502).

        ``trajectories``/``obstacle_trajs`` optionally override the live
        state — pipelined drivers pass the dispatch-time snapshots so a
        prepared next-tick ``update`` (which rebuilds ``self.trajectories``
        and reloads obstacles) cannot shift the classification of the
        in-flight tick's winner."""
        trajectories = (self.trajectories if trajectories is None
                        else trajectories)
        obstacle_trajs = (self._obstacle_trajs if obstacle_trajs is None
                          else obstacle_trajs)
        if not trajectories:
            return TOPOLOGY_NO_MATCH
        n = min(len(path_xy), self.config.N + 1)
        # One batched signature pass over [query, guidance trajectories]
        stack = np.stack([np.asarray(path_xy[:n], dtype=float)]
                         + [np.asarray(t.positions[:n], dtype=float)
                            for t in trajectories])
        sigs = self._signature_batch(stack, obstacle_trajs[:, :n])
        sig = sigs[0]
        for traj, tr_sig in zip(trajectories, sigs[1:]):
            if same_homotopy_class(sig, tr_sig, self._class_threshold):
                return traj.topology_class
        return TOPOLOGY_NO_MATCH

    def override_selected_trajectory(self, topology_id: int, clear: bool,
                                     selected_path: Optional[np.ndarray] = None
                                     ) -> None:
        """Record which topology the planner actually followed
        (guidance_constraints.cpp:504-518)."""
        if clear:
            self._selected_class = -1
            self._selected_path = None
            return
        self._selected_class = topology_id
        if selected_path is not None:
            self._selected_path = np.asarray(selected_path, dtype=float)
            self._known_classes.append((topology_id, self._selected_path))
            self._known_classes = self._known_classes[-8:]  # bounded memory
        else:
            for traj in self.trajectories:
                if traj.topology_class == topology_id:
                    self._selected_path = traj.positions
                    self._known_classes.append((topology_id, traj.positions))
                    self._known_classes = self._known_classes[-8:]
                    break

    def reset(self) -> None:
        self.trajectories = []
        self._selected_class = -1
        self._selected_path = None
        self._known_classes = []
        self._class_counter = 0
