"""Scalar NumPy oracle of the reference renderer semantics.

An independent, readable, per-ray recursive implementation of the algorithm
in /root/reference/src/main.rs (cast 180-326, reflect 328-341, refract
343-405, shade 407-464, ray_trace 466-519).  The wavefront renderer is
validated against this oracle on tiny images; the oracle itself is written
scalar-style so its structure matches the reference prose, not the
framework's (catching vectorization bugs rather than sharing them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

FRONT, BACK, BOTH = 0, 1, 2
EPS = np.float32(np.finfo(np.float32).eps)
THRESHOLD = 0.001


def _np(x):
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass
class OHit:
    prim: int
    obj: int
    t: float
    pos: np.ndarray
    normal: np.ndarray
    uv: np.ndarray
    backface: bool
    ray_d: np.ndarray
    ray_face: int


class OracleWorld:
    """NumPy view of a built Scene + its texture set."""

    def __init__(self, scene, textures):
        g = lambda a: np.asarray(a, dtype=np.float64)
        self.tri_v = g(scene.tri_v)
        self.tri_n = g(scene.tri_n)
        self.tri_uv = g(scene.tri_uv)
        self.tri_obj = np.asarray(scene.tri_obj)
        self.sph_c = g(scene.sph_c)
        self.sph_r = g(scene.sph_r)
        self.sph_obj = np.asarray(scene.sph_obj)
        self.T = self.tri_v.shape[0]
        self.S = self.sph_c.shape[0]
        self.mat = {
            "diffuse": g(scene.mat_diffuse),
            "shiness": g(scene.mat_shiness),
            "specular": g(scene.mat_specular),
            "smoothness": g(scene.mat_smoothness),
            "transparency": g(scene.mat_transparency),
            "refraction": g(scene.mat_refraction),
            "decay": g(scene.mat_decay),
            "normal": g(scene.mat_normal),
            "tex": np.asarray(scene.mat_tex),
        }
        self.light_type = np.asarray(scene.light_type)
        self.light_origin = g(scene.light_origin)
        self.light_dir = g(scene.light_dir)
        self.light_color = g(scene.light_color)
        self.light_angle = g(scene.light_angle)
        self.light_softness = g(scene.light_softness)
        self.textures = textures

    # --- material point-evaluation (materials.rs:33-37, 85-103) ---
    def approx_material(self, obj: int, uv: np.ndarray) -> dict:
        m = {k: (v[obj].copy() if v.ndim > 1 else float(v[obj])) for k, v in self.mat.items()}
        tex = int(self.mat["tex"][obj])
        if tex > 0:
            t = self.textures[tex]
            uv1 = np.asarray(uv, np.float32).reshape(1, 2)
            m["diffuse"] = np.asarray(t.diffuse(uv1), np.float64).reshape(3)
            m["normal"] = np.asarray(t.normal(uv1), np.float64).reshape(3)
        return m

    # --- World::cast (main.rs:180-326) ---
    def cast(self, o, d, face=FRONT, excl_prim=-1, excl_face=FRONT) -> Optional[OHit]:
        o = _np(o)
        d = _np(d)
        best = None

        def excluded(pid, backface):
            if excl_prim != pid:
                return False
            if excl_face == FRONT:
                return not backface
            if excl_face == BACK:
                return backface
            return True

        for i in range(self.T):
            v = self.tri_v[i]
            a = v[1] - v[0]
            b = v[2] - v[1]
            fn = np.cross(a, b)
            fn = fn / np.linalg.norm(fn)
            backface = float(np.dot(fn, d)) > 0.0
            if (backface and face == FRONT) or (not backface and face == BACK):
                continue
            if excluded(i, backface):
                continue
            denom = np.dot(fn, d)
            dd = np.dot(fn, v[0])
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (dd - np.dot(fn, o)) / denom
            if not np.isfinite(t) or t <= 0.0:
                continue
            p = o + d * t
            areas = np.array([
                np.dot(np.cross(v[2] - v[1], p - v[1]), fn),
                np.dot(np.cross(v[0] - v[2], p - v[2]), fn),
                np.dot(np.cross(v[1] - v[0], p - v[0]), fn),
            ])
            if np.any(areas < 0.0):
                continue
            if best is not None and best.t < t:
                continue
            area2 = np.dot(np.cross(v[1] - v[0], v[2] - v[0]), fn)
            bary = areas / area2
            normal = (self.tri_n[i] * bary[:, None]).sum(axis=0)
            if backface:
                normal = -normal
            uv = (self.tri_uv[i] * bary[:, None]).sum(axis=0)
            best = OHit(i, int(self.tri_obj[i]), float(t), p, normal, uv,
                        backface, d.copy(), face)

        for j in range(self.S):
            c, r = self.sph_c[j], float(self.sph_r[j])
            w = c - o
            dist = np.linalg.norm(np.cross(w, d))
            if dist > r:
                continue
            tc = float(np.dot(d, w))
            k = np.sqrt(max(r * r - dist * dist, 0.0))
            if face == FRONT:
                t, backface = tc - k, False
            elif face == BACK:
                t, backface = tc + k, True
            else:
                t, backface = (tc + k, True) if tc < k else (tc - k, False)
            if t <= 0.0:
                continue
            if excluded(self.T + j, backface):
                continue
            if best is not None and best.t < t:
                continue
            p = o + d * t
            n = (p - c) / np.linalg.norm(p - c)
            if backface:
                n = -n
            uv = np.array([
                np.arccos(np.clip(n[1], -1, 1)) / np.pi,
                np.arctan2(n[2], n[0]) / (2 * np.pi) + 0.5,
            ])
            best = OHit(self.T + j, int(self.sph_obj[j]), float(t), p, n, uv,
                        backface, d.copy(), face)
        return best

    # --- reflect (main.rs:328-341) ---
    def get_reflect(self, hit: OHit):
        l = hit.ray_d
        n = hit.normal
        refl = l - 2.0 * np.dot(l, n) * n
        refl = refl / np.linalg.norm(refl)
        excl_face = invert_face(BACK if hit.backface else FRONT)
        return hit.pos, refl, hit.ray_face, hit.prim, excl_face

    # --- refract with TIR interior march (main.rs:343-405) ---
    def get_refract(self, hit: OHit, max_distance: float):
        def refract(n, l, k):
            cos = -np.dot(l, n)
            if k * k >= 1.0 - cos * cos:
                v = (l + n * cos) / k - n * np.sqrt(1.0 - (1.0 - cos * cos) / (k * k))
                return v / np.linalg.norm(v)
            return None

        m = self.approx_material(hit.obj, hit.uv)
        k = m["refraction"]
        rin = refract(hit.normal, hit.ray_d, k)
        if rin is None:
            return None  # Trapped
        hit_in = self.cast(hit.pos, rin, BACK, hit.prim, FRONT)
        if hit_in is None:
            return None  # Infinite -> black at both call sites
        travel = np.linalg.norm(hit_in.pos - hit.pos)
        rout = refract(hit_in.normal, hit_in.ray_d, 1.0 / k)
        retry = 0
        while rout is None and travel <= max_distance and retry < 10:
            prev = hit_in.pos
            o2, d2, f2, ep2, ef2 = self.get_reflect(hit_in)
            hit_in = self.cast(o2, d2, f2, ep2, ef2)
            if hit_in is None:
                return None
            travel += np.linalg.norm(hit_in.pos - prev)
            rout = refract(hit_in.normal, hit_in.ray_d, 1.0 / k)
            retry += 1
        if rout is None:
            return None  # Trapped
        return travel, hit_in.pos, rout, hit_in.prim  # escape: FRONT, excl BACK

    # --- adjust_normal (materials.rs:40-44) ---
    @staticmethod
    def adjust_normal(mat_normal, hit_normal):
        n = _np(hit_normal)
        v = _np(mat_normal)
        if n[2] < -1.0 + 1e-6:
            return np.array([-v[0], v[1], -v[2]])
        qw = 1.0 + n[2]
        qv = np.array([-n[1], n[0], 0.0])
        q2 = qw * qw + qv @ qv
        t = np.cross(qv, v) + qw * v
        return v + (2.0 / q2) * np.cross(qv, t)

    # --- lights (lights.rs:44-93) ---
    def approx_light(self, li: int, position):
        position = _np(position)
        ltype = int(self.light_type[li])
        color = self.light_color[li].copy()
        if ltype == 0:  # directional
            return dict(direction=self.light_dir[li].copy(), color=color, origin=None)
        origin = self.light_origin[li]
        offset = position - origin
        mag = np.linalg.norm(offset)
        if ltype == 1:  # spot
            ldir = self.light_dir[li]
            cosang = np.dot(ldir, offset) / (np.linalg.norm(ldir) * mag)
            angle = abs(np.arccos(np.clip(cosang, -1, 1)))
            spread = float(self.light_angle[li])
            if angle > spread:
                return None
            att = (1.0 - angle / spread) ** (float(self.light_softness[li]) + EPS)
            att = att / (mag + EPS)
            return dict(direction=offset / mag, color=color * att, origin=origin.copy())
        att = 1.0 / (mag + EPS)
        return dict(direction=offset / mag, color=color * att, origin=origin.copy())

    # --- get_shade (main.rs:407-464) ---
    def get_shade(self, hit: OHit):
        m = self.approx_material(hit.obj, hit.uv)
        normal = self.adjust_normal(m["normal"], hit.normal)
        total = np.zeros(3)
        for li in range(len(self.light_type)):
            light = self.approx_light(li, hit.pos)
            if light is None:
                continue
            cosine = -np.dot(light["direction"], normal)
            if cosine <= 0.0:
                continue
            occ = self.cast(hit.pos, -light["direction"], BACK, hit.prim, BACK)
            if occ is not None:
                if light["origin"] is None:
                    continue
                occ_dist = np.linalg.norm(hit.pos - occ.pos)
                light_dist = np.linalg.norm(hit.pos - light["origin"])
                if occ_dist < light_dist:
                    continue
            ldir = -light["direction"]
            view = -hit.ray_d
            shine = m["shiness"]
            diffuse = get_diffuse(m, normal, ldir) * light["color"]
            specular = get_specular(m, normal, ldir, view) * light["color"]
            total = total + diffuse * (1.0 - shine) + specular * shine
        return total

    # --- Whitted ray_trace (main.rs:466-519) ---
    def ray_trace(self, depth, contribution, o, d, face=FRONT, excl_prim=-1,
                  excl_face=FRONT):
        if contribution < THRESHOLD:
            return np.zeros(3)
        hit = self.cast(o, d, face, excl_prim, excl_face)
        if hit is None:
            return np.zeros(3)
        m = self.approx_material(hit.obj, hit.uv)

        shade_c = (1.0 - m["shiness"]) * (1.0 - m["transparency"])
        if contribution * shade_c >= THRESHOLD:
            shade = self.get_shade(hit)
        else:
            shade = np.zeros(3)
        if depth <= 0:
            return shade

        refl_c = m["shiness"] * (1.0 - m["transparency"])
        if contribution * refl_c >= THRESHOLD:
            ro, rd, rf, rep, ref_ = self.get_reflect(hit)
            reflection = self.ray_trace(depth - 1, contribution * refl_c,
                                        ro, rd, rf, rep, ref_)
        else:
            reflection = np.zeros(3)

        refr_c = m["transparency"]
        refraction = np.zeros(3)
        if contribution * refr_c > THRESHOLD:
            out = self.get_refract(hit, 100.0)
            if out is not None:
                travel, epos, edir, eprim = out
                sub = self.ray_trace(depth - 1, contribution * refr_c,
                                     epos, edir, FRONT, eprim, BACK)
                refraction = sub * (m["decay"] ** travel)

        return shade * shade_c + reflection * refl_c + refraction * refr_c

    # --- distributed MC trace (main.rs:521-614) ---
    def distributed_ray_trace(self, rng, depth, hit: OHit):
        shade = self.get_shade(hit)
        if depth <= 0:
            return shade
        m = self.approx_material(hit.obj, hit.uv)
        w = [
            (1.0 - m["shiness"]) * (1.0 - m["transparency"]),
            m["shiness"] * (1.0 - m["transparency"]),
            m["transparency"],
        ]
        r = rng.uniform(0.0, sum(w))
        sel = 0 if r < w[0] else (1 if r < w[0] + w[1] else 2)

        def scatter(direction, exponent):
            phi = np.arccos((1.0 - rng.uniform(0.0, 1.0)) ** exponent)
            theta = rng.uniform(-np.pi, np.pi)
            sph = np.array([
                np.sin(phi) * np.cos(theta),
                np.sin(phi) * np.sin(theta),
                np.cos(phi),
            ])
            return self.adjust_normal(sph, direction / np.linalg.norm(direction))

        if sel in (0, 1):
            if sel == 0:
                sdir = scatter(-hit.normal, 1.0)
            else:
                sdir = scatter(hit.ray_d, m["smoothness"])
            cosine = -np.dot(hit.normal, sdir)
            if cosine <= 0.0:
                return np.zeros(3)
            scattered = dataclasses.replace(hit, ray_d=sdir)
            ro, rd, rf, rep, ref_ = self.get_reflect(scattered)
            nh = self.cast(ro, rd, rf, rep, ref_)
            if nh is None:
                return self.get_shade(scattered)
            x = self.distributed_ray_trace(rng, depth - 1, nh)
            if sel == 0:
                brdf = get_diffuse(m, hit.normal, rd)
            else:
                brdf = get_specular(m, hit.normal, rd, -hit.ray_d)
            s = x * brdf
            return 0.5 * self.get_shade(nh) + 0.5 * s

        sdir = scatter(hit.ray_d, m["smoothness"])
        cosine = -np.dot(hit.normal, sdir)
        if cosine <= 0.0:
            return np.zeros(3)
        scattered = dataclasses.replace(hit, ray_d=sdir)
        out = self.get_refract(scattered, 100.0)
        if out is None:
            return np.zeros(3)
        travel, epos, edir, eprim = out
        nh = self.cast(epos, edir, FRONT, eprim, BACK)
        if nh is None:
            return np.zeros(3)
        x = self.distributed_ray_trace(rng, depth - 1, nh)
        return (x + self.get_shade(nh)) * (m["decay"] ** travel)

    def render_whitted(self, camera, width, height, depth=5):
        """Reference main() pass 1 on a tiny image (main.rs:1084-1111)."""
        fovy = float(camera.fovy)
        center = _np(camera.center)
        toward = _np(camera.toward)
        toward = toward / np.linalg.norm(toward)
        up0 = _np(camera.up)
        right = np.cross(toward, up0)
        right /= np.linalg.norm(right)
        up = np.cross(right, toward)
        up /= np.linalg.norm(up)
        x = np.tan(fovy / 2.0) * right
        y = np.tan(fovy / 2.0) * up
        origin = center + toward * float(camera.near)
        img = np.zeros((height, width, 3))
        for py in range(height):
            for px in range(width):
                cy = (height / 2.0 - py) / height
                cx = (px - width / 2.0) / height
                d = cx * x + cy * y + toward
                d = d / np.linalg.norm(d)
                img[py, px] = self.ray_trace(depth, 1.0, origin, d)
        return img


def invert_face(face):
    return {FRONT: BACK, BACK: FRONT, BOTH: BOTH}[face]


def get_diffuse(m, normal, light_dir):
    cosine = np.dot(light_dir, normal)
    if cosine > 0.0:
        return m["diffuse"] * cosine
    return np.zeros(3)


def get_specular(m, normal, light_dir, view_dir):
    cosine = np.dot(light_dir, normal)
    if cosine <= 0.0:
        return np.zeros(3)
    reflected = 2.0 * cosine * normal - light_dir
    e = 1.0 / (m["smoothness"] + EPS)
    energy = (e + 8.0) / (8.0 * np.pi)
    amount = max(np.dot(reflected, view_dir), 0.0) ** e * energy
    return m["specular"] * amount
