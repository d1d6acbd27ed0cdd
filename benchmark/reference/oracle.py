"""Frozen copy of the NumPy oracle env: one env of the reference's drone
world, scalar loops, float64 (copied from rvo3d_tpu_torch/env/oracle.py at
commit 9c4d68f085eba6da2a2a461640d8c4e22e7131e6; the benchmark imports
nothing of the port, so a later change to the port leaves this copy as it
is).

It re-states the reference env (ZSHCRWY25/3DRVO-MARL-CollisionAvoidance:
mdin.py, ir_gym.py, rvo_inter.py, drone.py), quirks included; each method
cites the reference lines it mirrors. One addition to the copied file:
`safe_rewards`, the configuration option the benchmarked configurations
set (the port's env/reward.py documents it): the rvo reward's velocity
penalty is 0 where the rounded desired velocity is 0 and divides by
max(|des_vel|, 1e-6) elsewhere, and the rvo reward is clamped to
[-100, 100] before its rounding to 3 decimals. With safe_rewards False the
copy computes what the original computes.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

INF = float("inf")


def _wraptopi(theta):
    # vel_obs3D.py:195-202 (single correction only)
    if theta > math.pi:
        theta = theta - 2 * math.pi
    if theta < -math.pi:
        theta = theta + 2 * math.pi
    return theta


def _angle_between(a, b):
    # vel_obs3D.get_beta (vel_obs3D.py:44-66)
    dot = float(np.dot(a, b))
    mag = float(np.linalg.norm(a)) * float(np.linalg.norm(b))
    cos = dot / mag if mag != 0 else 0.0
    return round(_wraptopi(float(np.arccos(np.clip(cos, -1.0, 1.0)))), 2)


def _angle_between_eps(a, b):
    # ir_gym.calculate_angle_between_vectors, shadowing staticmethod
    # (ir_gym.py:447-473)
    eps = 1e-8
    mag_a = math.sqrt(a[0] ** 2 + a[1] ** 2 + a[2] ** 2 + eps)
    mag_b = math.sqrt(b[0] ** 2 + b[1] ** 2 + b[2] ** 2 + eps)
    dot = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    if mag_a < 1e-6 or mag_b < 1e-6:
        return 0.0
    cos = np.clip(dot / (mag_a * mag_b), -1.0 + eps, 1.0 - eps)
    return math.acos(cos)


def _vo_exp_time(rel_p, rel_v_origin, r_sum):
    # vel_obs3D.cal_vo_exp_tim (vel_obs3D.py:145-182)
    rvx, rvy, rvz = -rel_v_origin[0], -rel_v_origin[1], -rel_v_origin[2]
    a = rvx ** 2 + rvy ** 2 + rvz ** 2
    b = 2 * rel_p[0] * rvx + 2 * rel_p[1] * rvy + 2 * rel_p[2] * rvz
    c = rel_p[0] ** 2 + rel_p[1] ** 2 + rel_p[2] ** 2 - r_sum ** 2
    if c <= 0:
        return 0.0
    disc = b ** 2 - 4 * a * c
    if disc <= 0:
        return INF
    t1 = (-b + math.sqrt(disc)) / (2 * a)
    t2 = (-b - math.sqrt(disc)) / (2 * a)
    if t1 < 0 and t2 < 0:
        return -1.0
    t3 = t1 if t1 >= 0 else INF
    t4 = t2 if t2 >= 0 else INF
    return min(t3, t4)


class OracleDrone:
    """Mirror of the reference drone state machine (drone.py:13-490)."""

    def __init__(self, idx, waypoints, n_points, *, radius=0.2, priority=5.0,
                 goal_threshold=0.4, dt=1.0, vel_max=1.0):
        self.id = idx
        self.waypoints = [np.array(w, float) for w in waypoints]
        self.n_points = n_points
        self.radius = radius
        self.priority = priority
        self.goal_threshold = goal_threshold
        self.dt = dt
        self.vel_max = vel_max * np.ones(3)
        self.starting = self.waypoints[0]
        self.destination = self.waypoints[-1]
        self.route_len = sum(
            float(np.linalg.norm(self.waypoints[k + 1] - self.waypoints[k]))
            for k in range(n_points - 1)
        )
        self.reset()

    def reset(self):
        # drone.reset (drone.py:270-291)
        self.state = self.starting.copy()
        self.previous_state = self.starting.copy()
        self.i = 1
        self.vel = np.zeros(3)
        self.arrive_flag = False
        self.dest_arrive_flag = False
        self.collision_flag = False
        self.real_route_len = 0.0
        self.max_deviation = 0.0
        self.extra_len = 0.0
        self.velocity = 0.0
        self.yaw = 0.0
        self.pitch = 0.0
        self.current_des = self.waypoints[1] if self.n_points > 1 else self.destination
        self.previous_des = self.waypoints[0]

    # --- geometry helpers ---
    def cal_des_vel(self):
        # drone.cal_des_vel (drone.py:199-210)
        dif = self.current_des - self.state
        dis = float(np.linalg.norm(dif))
        if dis > self.goal_threshold:
            azimuth = math.atan2(dif[1], dif[0])
            elevation = math.atan2(dif[2], float(np.linalg.norm(dif[0:2])))
            direction = np.array([
                math.cos(azimuth) * math.cos(elevation),
                math.sin(azimuth) * math.cos(elevation),
                math.sin(elevation),
            ])
            return np.round(self.vel_max * direction, 3)
        return np.zeros(3)

    def deviation_from_route(self):
        # drone.calculate_deviation (drone.py:366-406): point-to-LINE
        s, e, p0 = self.previous_des, self.current_des, self.state
        d = e - s
        mag = float(np.linalg.norm(d))
        if mag == 0:
            return 0.0
        d_hat = d / mag
        t = float(np.dot(p0 - s, d_hat))
        q = s + t * d_hat
        return float(np.linalg.norm(p0 - q))

    def dronestate(self):
        # drone.dronestate (drone.py:254-263) incl. max_deviation side effect
        dev = self.deviation_from_route()
        if dev > self.max_deviation:
            self.max_deviation = dev
        return np.concatenate([
            self.state, self.vel, [self.radius], [self.priority],
            self.cal_des_vel(), [dev],
        ])

    def arrive(self, pos, des):
        return float(np.linalg.norm(pos[0:3] - des[0:3])) <= self.goal_threshold

    def destination_arrive(self, pos):
        # drone.destination_arrive (drone.py:182-192) incl. extra_len side effect
        if float(np.linalg.norm(pos[0:3] - self.destination[0:3])) <= self.goal_threshold:
            self.extra_len = self.real_route_len - self.route_len
            return True
        return False

    def out_of_map(self, map_size):
        x, y, z = self.state
        return (x < 0 or x > map_size[0] or y < 0 or y > map_size[1]
                or z < 0 or z > map_size[2])

    def kinematic_step(self, action):
        # drone.kinematicstep + helpers (drone.py:431-490)
        max_acc, max_ang = 1.0, 90.0
        acc = float(np.clip(action[0] * max_acc, -max_acc, max_acc))
        yaw_d = float(np.clip(action[1] * max_ang, -max_ang, max_ang))
        pitch_d = float(np.clip(action[2] * max_ang, -max_ang, max_ang))
        self.velocity = max(self.velocity + acc * 1, 0.0)
        self.yaw = (self.yaw + yaw_d) % 360
        self.pitch = float(np.clip(self.pitch + pitch_d, -90, 90))
        yr, pr = math.radians(self.yaw), math.radians(self.pitch)
        return np.array([
            self.velocity * math.cos(pr) * math.cos(yr),
            self.velocity * math.cos(pr) * math.sin(yr),
            self.velocity * math.sin(pr),
        ])

    def move_forward(self, act, noise_values=None):
        # drone.move_forward (drone.py:96-119) with effective stop=True.
        # noise_values: optional pre-drawn control noise; the reference
        # perturbs the position update only (motion() rounds vel+noise for
        # next_state, move() stores the clean vel — drone.py:150-151,163-169)
        self.velocity = float(np.linalg.norm(self.vel))
        vel = self.kinematic_step(act)
        if self.dest_arrive_flag or self.collision_flag:
            vel = np.zeros(3)
        vel_eff = (np.round(vel + np.asarray(noise_values, float), 2)
                   if noise_values is not None else vel)
        self.previous_state = self.state
        self.state = self.state + vel_eff * self.dt
        self.vel = vel
        self.real_route_len += float(np.linalg.norm(self.state - self.previous_state))
        if self.arrive(self.state, self.current_des) and not self.destination_arrive(self.state):
            if self.i < self.n_points - 1:
                # current_des_new (drone.py:122-130)
                self.i += 1
                self.previous_des = self.current_des
                self.current_des = self.waypoints[self.i]
                self.arrive_flag = False


class OracleEnv:
    """Mirror of mdin -> ir_gym -> env_base -> env_drone for one env."""

    def __init__(self, world, *, neighbor_num=10, env_train=True,
                 exp_radius=0.2, ctime_threshold=2.0, delta_t=1.0,
                 radius=0.2, priority=5.0, safe_rewards=False):
        self.map_size = list(world.map_size)
        self.building_list = [list(b) for b in world.building_list]
        self.nm = neighbor_num
        self.env_train = env_train
        self.exp_radius = exp_radius
        self.ctime_threshold = ctime_threshold
        self.delta_t = delta_t
        self.safe_rewards = safe_rewards
        self.drones: List[OracleDrone] = [
            OracleDrone(i, world.waypoints_list[i], world.n_points_list[i],
                        radius=radius, priority=priority)
            for i in range(world.drone_num)
        ]

    # ---- rvo_inter (rvo_inter.py) ----
    def _preprocess(self, state, state_list):
        # rvo_inter.preprocess (rvo_inter.py:85-107)
        p_self = np.array(state[0:3])
        odro = []
        for s in state_list:
            p_other = np.array(s[0:3])
            if np.all(p_self == p_other):
                continue
            if float(np.linalg.norm(p_self - p_other)) <= 10:
                odro.append(s)
        obs_b = []
        for b in self.building_list:
            if b[2] > p_self[2] - 2:
                if float(np.linalg.norm(p_self[0:2] - np.array(b[0:2]))) <= 5:
                    obs_b.append(b)
        return odro, obs_b

    def _config_vo_circle2(self, state, odro, action):
        # rvo_inter.config_vo_circle2 (rvo_inter.py:116-196)
        action = np.asarray(action, float)
        if float(np.linalg.norm(action)) < 1e-5:
            action = np.zeros(3)
        x, y, z, vx, vy, vz, r = state[0:7]
        mx, my, mz, mvx, mvy, mvz, mr = odro[0:7]
        rel = np.array([mx - x, my - y, mz - z])
        dis_mr = math.sqrt(rel[0] ** 2 + rel[1] ** 2 + rel[2] ** 2)
        real_dis = dis_mr
        collision = False
        if self.env_train:
            if dis_mr <= r + mr:
                dis_mr = r + mr
                collision = True
        else:
            if dis_mr <= r - self.exp_radius + mr:
                collision = True
            if dis_mr <= r + mr:
                dis_mr = r + mr
        if collision:
            return ([x, y, z, rel[0], rel[1], rel[2], 0, 0, 0],
                    False, 0.0, True, dis_mr)
        if vx * rel[0] + vy * rel[1] + vz * rel[2] <= 0:
            return ([x, y, z, rel[0], rel[1], rel[2], 0, -1, -1],
                    False, 0.0, False, dis_mr)
        # cone construction
        alpha = round(_wraptopi(math.asin((r + mr) / real_dis)), 2)
        pr = state[7] / (state[7] + odro[7])
        paa = np.array([
            pr * (2 * x + (vx + mvx) * 1),
            pr * (2 * y + (vy + mvy) * 1),
            pr * (2 * z + (vz + mvz) * 1),
        ])
        rel_v = np.array([2 * action[0] - mvx - vx,
                          2 * action[1] - mvy - vy,
                          2 * action[2] - mvz - vz])
        # membership (rvo_inter.vo_out_jud_vector, rvo_inter.py:212-228)
        panew = np.array([x + 2 * action[0] * self.delta_t,
                          y + 2 * action[1] * self.delta_t,
                          z + 2 * action[2] * self.delta_t])
        beta = _angle_between(rel, panew - paa)
        outside = not (alpha > beta)
        vo_flag = False
        exp_time = INF
        if not outside:
            t = _vo_exp_time(rel, rel_v, r + mr)
            if t < self.ctime_threshold:
                vo_flag = True
                exp_time = t
        input_exp_time = 1 / (exp_time + 0.2)
        min_dis = real_dis - mr
        obs9 = [paa[0], paa[1], paa[2], rel[0], rel[1], rel[2],
                alpha, min_dis, input_exp_time]
        return obs9, vo_flag, exp_time, False, min_dis

    def _check_building_col(self, state, building):
        # rvo_inter.check_col_with_budilding (rvo_inter.py:198-209)
        x, y, z = state[0:3]
        r = state[6]
        if z <= building[2]:
            d = math.sqrt((x - building[0]) ** 2 + (y - building[1]) ** 2)
            if d <= r + building[3]:
                return True
        return False

    def _config_vo_inf(self, state, state_list, action):
        # rvo_inter.config_vo_inf (rvo_inter.py:20-61)
        odro, obs_b = self._preprocess(state, state_list)
        collision = any(self._check_building_col(state, b) for b in obs_b) \
            if obs_b else False
        vo_list = [self._config_vo_circle2(state, o, action) for o in odro]
        obs_vo, vo_flag, min_exp = [], False, INF
        for inf in vo_list:
            if inf[1] is True:
                obs_vo.append(inf[0])
                vo_flag = True
                if inf[2] < min_exp:
                    min_exp = inf[2]
            if inf[3] is True:
                collision = True
        obs_vo.sort(reverse=True, key=lambda o: (-o[-1], o[-2]))
        if len(obs_vo) > self.nm:
            obs_vo = obs_vo[-self.nm:]
        if self.nm == 0:
            obs_vo = []
        return obs_vo, vo_flag, min_exp, collision, obs_b

    def _config_vo_reward(self, state, state_list, action):
        # rvo_inter.config_vo_reward (rvo_inter.py:63-83)
        odro, _ = self._preprocess(state, state_list)
        vo_list = [self._config_vo_circle2(state, o, action) for o in odro]
        vo_flag, min_exp, min_dis = False, INF, INF
        for inf in vo_list:
            if inf[4] < min_dis:
                min_dis = inf[4]
            if inf[1] is True:
                vo_flag = True
                if inf[2] < min_exp:
                    min_exp = inf[2]
        return vo_flag, min_exp, min_dis

    # ---- ir_gym rewards (ir_gym.py) ----
    def _rvo_reward(self, state, state_list, action):
        # ir_gym.rvo_reward_cal (ir_gym.py:64-133)
        vo_flag, min_exp, _ = self._config_vo_reward(state, state_list, action)
        des_vel = np.round(np.squeeze(state[8:11]), 3)
        denom = float(np.linalg.norm(des_vel))
        if self.safe_rewards:
            vel_penalty = (0.2 * float(np.linalg.norm(action)) / max(denom, 1e-6)
                           if denom > 0.0 else 0.0)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                vel_penalty = 0.2 * float(np.linalg.norm(action)) / denom
        angle = _angle_between_eps(des_vel, np.asarray(action, float))
        if -math.pi / 18 < angle < math.pi / 18:
            angle_punish = 3.0
        elif -math.pi / 6 < angle < math.pi / 6:
            angle_punish = 1.0
        elif -math.pi / 3 < angle < math.pi / 3:
            angle_punish = 0.5
        elif -math.pi / 2 < angle < math.pi / 2:
            angle_punish = 0.0
        else:
            angle_punish = -4.0
        safety = 0.0
        if vo_flag:
            urgency = 0.0
            if min_exp < 2:
                urgency = -8.0 * math.exp(-min_exp / 0.5)
            safety = -2.5 + urgency
        total = angle_punish + vel_penalty + safety
        if self.safe_rewards:
            total = min(max(total, -100.0), 100.0)
        return float(np.round(total, 3))

    def _mov_reward(self, collision, arrive_flag_r, waypoint_num, n_points_m1,
                    dest_flag_r, deviation, len_flag, exlen):
        # ir_gym.mov_reward (ir_gym.py:256-311)
        if collision:
            return -50.0
        reward = 0.0
        if arrive_flag_r:
            reward += 3.0 * 0.95 ** (n_points_m1 - waypoint_num)
        if dest_flag_r:
            reward += 20.0
        d = deviation * 10
        dev_pen = -1.5 * (2 / (1 + math.exp(-(d - 5) / 0.3)))
        if len_flag:
            exlen_pen = -0.3 * math.log(exlen + 1 + 1e-6)
            if exlen_pen < -6 or math.isnan(exlen_pen):
                exlen_pen = -6.0
        else:
            exlen_pen = 0.0
        return float(np.round(reward + dev_pen + exlen_pen, 3))

    def total_states(self):
        return [d.dronestate() for d in self.drones]

    def _observation_reward(self, drone, other_states, action):
        # ir_gym.observation_reward (ir_gym.py:156-254)
        drone_state = drone.dronestate()
        waypoint_num = drone.i
        n_points_m1 = drone.n_points - 1
        if drone.arrive(drone.state, drone.current_des) and not drone.arrive_flag:
            drone.arrive_flag = True
            arrive_flag_r = True
        else:
            arrive_flag_r = False
        dest_flag_r = False
        if drone.arrive_flag:
            if drone.destination_arrive(drone.state) and not drone.dest_arrive_flag:
                drone.dest_arrive_flag = True
                dest_flag_r = True
        deviation = drone.deviation_from_route()
        exlen = drone.real_route_len - drone.route_len + 4
        len_flag = exlen > 0
        obs_vo, vo_flag, min_exp, collision, _ = self._config_vo_inf(
            drone_state, other_states, action)
        if drone.out_of_map(self.map_size):
            collision = True
        propri = np.concatenate([
            drone.state, np.squeeze(drone.vel), [drone.radius],
            [drone.priority], np.squeeze(drone.cal_des_vel()), [deviation],
        ])
        exter = (np.concatenate(obs_vo) if obs_vo
                 else np.zeros(9))
        observation = np.round(np.concatenate([propri, exter]), 2)
        r_mov = self._mov_reward(collision, arrive_flag_r, waypoint_num,
                                 n_points_m1, dest_flag_r, deviation,
                                 len_flag, exlen)
        done = bool(collision)
        info = bool(drone.arrive_flag)
        finish = bool(drone.dest_arrive_flag)
        return observation, r_mov, done, info, finish

    def _observation(self, drone, state_list):
        # ir_gym.observation (ir_gym.py:334-358): zero action
        drone_state = drone.dronestate()
        obs_vo, _, _, _, _ = self._config_vo_inf(
            drone_state, state_list, np.zeros(3))
        exter = (np.concatenate(obs_vo) if obs_vo else np.zeros(9))
        return np.round(np.concatenate([drone_state, exter]), 2)

    # ---- public mdin-style API (mdin.py:19-46) ----
    def reset(self):
        for d in self.drones:
            d.reset()
        states = self.total_states()
        return [self._observation(d, states) for d in self.drones]

    def reset_one(self, idx):
        self.drones[idx].reset()

    def env_observation(self):
        states = self.total_states()
        return [
            self._observation(d, [s for j, s in enumerate(states) if j != i])
            for i, d in enumerate(self.drones)
        ]

    def step(self, abs_action_list, noise_values=None):
        """mdin.drone_step (mdin.py:19-30): rvo rewards on pre-step states,
        physics, obs/mov rewards on post-step states; reward = rvo + mov.
        noise_values: optional [N, 3] pre-drawn control noise (parity with
        the vectorized env's noise path under injected samples)."""
        states = self.total_states()
        rvo_rewards = []
        for i, d in enumerate(self.drones):
            others = [s for j, s in enumerate(states) if j != i]
            rvo_rewards.append(
                self._rvo_reward(states[i], others, abs_action_list[i]))

        for i, (d, a) in enumerate(zip(self.drones, abs_action_list)):
            d.move_forward(np.asarray(a, float),
                           None if noise_values is None else noise_values[i])

        post_states = self.total_states()
        obs_list, rew_list, done_list, info_list, finish_list = [], [], [], [], []
        for i, d in enumerate(self.drones):
            others = [s for j, s in enumerate(post_states) if j != i]
            o, r_mov, done, info, fin = self._observation_reward(
                d, others, abs_action_list[i])
            obs_list.append(o)
            rew_list.append(rvo_rewards[i] + r_mov)
            done_list.append(done)
            info_list.append(info)
            finish_list.append(fin)
        return obs_list, rew_list, done_list, info_list, finish_list
