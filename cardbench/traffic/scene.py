"""The world of one robot's closed-loop tick run, made from a traffic file
and a seed: a straight reference path along +x from the origin, the robot
at its start, and pedestrians that cross the path back and forth.

Each pedestrian i starts at its anchor (x_i, y_i) jittered and walks at
its own speed towards (x_i, -y_i), turns there and walks back, so that
every tick of a run sees pedestrians in range. An episode ends where the
robot comes within ``end_margin`` of the path's end; the next starts from
the origin. The traffic file fixes a pool of ``scenes`` jitter and speed
draws (from ``pool_seed``); the run's seed fixes the order in which the
episodes take them, so that every seed runs the same set of scenes. The
robot moves by one RK4 step of the unicycle per tick under the first
control of its plan. Plain numpy; the program sees only the observations
(:meth:`Scene.observations`) and the robot's state."""

from __future__ import annotations

import numpy as np


class Scene:
    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.dt = float(traffic["dt"])
        self.length = float(traffic["path_length"])
        ped = traffic["pedestrians"]
        n = len(ped["anchors"])
        self.pool = []
        for k in range(int(traffic["scenes"])):
            rng = np.random.default_rng([int(traffic["pool_seed"]), k])
            jit = rng.uniform(-1.0, 1.0, (n, 2)) * np.asarray(
                ped["jitter"], dtype=float)
            lo, hi = ped["speed"]
            self.pool.append((jit, rng.uniform(lo, hi, n)))
        self.order = np.random.default_rng(
            [int(seed) % 2 ** 63, 3]).permutation(len(self.pool))
        self.episode = -1
        self.clock = 0.0
        self.reset()

    def reset(self):
        """Start the next episode: robot at the origin, new pedestrians."""
        ped = self.t["pedestrians"]
        self.episode += 1
        jit, self.speed = self.pool[self.order[self.episode % len(self.pool)]]
        self.start = np.asarray(ped["anchors"], dtype=float) + jit
        self.goal = self.start * np.array([1.0, -1.0])
        self.radius = float(ped["radius"])
        self.pos = self.start.copy()
        self.heading = self._unit(self.goal - self.pos)
        # x, y, psi, v, s
        self.robot = np.array([0.0, 0.0, 0.0, float(self.t["start_v"]), 0.0])

    @staticmethod
    def _unit(d):
        return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

    def velocities(self):
        return self.heading * self.speed[:, None]

    def observations(self):
        """(positions (n, 2), velocities (n, 2), radius) of the pedestrians
        as the planner observes them now."""
        return self.pos.copy(), self.velocities(), self.radius

    def step_pedestrians(self):
        """Every pedestrian one dt on; one that reaches its goal turns."""
        step = self.velocities() * self.dt
        to_goal = self.goal - self.pos
        arrive = np.sum(step * to_goal, axis=1) >= np.sum(to_goal ** 2, axis=1)
        self.pos = np.where(arrive[:, None], self.goal, self.pos + step)
        self.start, self.goal = (np.where(arrive[:, None], self.goal,
                                          self.start),
                                 np.where(arrive[:, None], self.start,
                                          self.goal))
        self.heading = self._unit(self.goal - self.pos)

    def advance_robot(self, a, w):
        """The robot one RK4 step (3 sub-steps) on under (a, w), its speed
        floored at 0; the clock by dt. True where the episode ended."""
        self.robot = rk4(self.robot, np.array([a, w]), self.dt)
        self.robot[3] = max(self.robot[3], 0.0)
        self.clock += self.dt
        return self.robot[0] >= self.length - float(self.t["end_margin"])


def rk4(x, u, dt, steps=3):
    """One step of the contouring unicycle (x, y, psi, v, s) under (a, w)."""
    def f(s):
        return np.array([s[3] * np.cos(s[2]), s[3] * np.sin(s[2]), u[1],
                         u[0], s[3]])

    h = dt / steps
    x = np.asarray(x, dtype=float).copy()
    for _ in range(steps):
        k1 = f(x)
        k2 = f(x + 0.5 * h * k1)
        k3 = f(x + 0.5 * h * k2)
        k4 = f(x + h * k3)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def path_points(length, n_points):
    """Waypoints of the straight reference path: (x, y) each (n,)."""
    x = np.linspace(0.0, float(length), int(n_points))
    return x, np.zeros_like(x)
