"""The plain reference of the sigma cells: the fixed-domain homogenization
estimate of BASELINE config 4 by one generalized Lanczos pass in the
M-inner product (Homogenization.jl tools/multishift_cg.jl), in plain
PyTorch on global vectors of the fine lattice's interior nodes.

The problem is worked out again from the benchmark's inputs: the box
[-R0, R0]^d of unit cubes (6 tetrahedra each, reference/mesh.py), the
per-cube per-axis conductivity field, the direction xi and the number of
refinements. The reference element's mass matrix and stiffness pieces come
from its own sub-tetrahedra; element products are dense GEMMs (TF32 off),
assembled on the lattice by integer coordinates. The recurrence is the
published one, step for step: q0 = M^-1 b0, the Lanczos basis of M^-1 A
with the mass solves by Jacobi-preconditioned CG (tol 1e-12 on the true
residual), the host's tridiagonal solves y_0 = (T + lam_0)^-1 beta0 e1,
y_k = lam_k (T + lam_k)^-1 y_(k-1), v_k = V y_k, and sigma from the box
integrals of each step with the 2^k scaling.

It imports nothing of the program and reads nothing it made; it computes
in the dtype it is given, so that float32 is the control.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .mesh import affine, ordered_box, refined_reference


def box_radius(k: int, n: int) -> int:
    return int(math.floor(2 ** (n - k * 0.5)))


def boundary_layer(lam: float, n: int) -> int:
    return int(math.floor(4 * (n + 1) * lam**-0.5))


def domain_radius(n: int) -> int:
    """R0: the k = 0 box and its boundary layer at lambda = 1."""
    return box_radius(0, n) + boundary_layer(1.0, n)


def reference_matrices(times: int):
    """(mass [n, n], stiffness pieces S [3, 3, n, n] with S[k, l] = sum_t
    vol_t g_t[:, k] g_t[:, l]^T, f [n, 3] = int grad phi_i, nodes [n, 3]) of
    the reference tetrahedron refined ``times`` times, float64 NumPy."""
    nodes, sub = refined_reference(times)
    n = len(nodes)
    p = nodes[sub]
    B = np.moveaxis(p[:, 1:, :] - p[:, :1, :], 1, 2)
    Binv = np.linalg.inv(B)
    G = np.concatenate([-Binv.sum(axis=1, keepdims=True), Binv], axis=1)  # [T, 4, 3]
    vol = np.abs(np.linalg.det(B)) / 6.0
    loc_m = (np.ones((4, 4)) + np.eye(4)) / 20.0
    mass = np.zeros((n, n))
    S = np.zeros((3, 3, n, n))
    f = np.zeros((n, 3))
    ii = np.repeat(sub, 4, axis=1).reshape(-1)
    jj = np.tile(sub, (1, 4)).reshape(-1)
    np.add.at(mass, (ii, jj), (vol[:, None, None] * loc_m[None]).reshape(-1))
    for k in range(3):
        for l in range(3):
            blk = vol[:, None, None] * G[:, :, k, None] * G[:, None, :, l]
            np.add.at(S[k, l], (ii, jj), blk.reshape(-1))
    np.add.at(f, sub.reshape(-1), np.repeat(vol[:, None] * 1.0, 4, axis=1).reshape(-1, 1)
              * G.reshape(-1, 3))
    return mass, S, f, nodes


class Problem:
    """The fixed-domain problem of field ``cond_field`` ([2 R0]^3 x 3) on
    the box of radius R0 = domain_radius(n), ``refinements`` red
    refinements of each tetrahedron, in ``dtype`` on ``device``."""

    def __init__(self, n, refinements, cond_field, xi, dtype=torch.float64, device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        R0 = domain_radius(n)
        self.n, self.R0 = n, R0
        nodes, els = ordered_box(R0)
        v0, J = affine(nodes, els)
        detJ = np.abs(np.linalg.det(J))
        Jinv = np.linalg.inv(J)
        centers = nodes[els].mean(axis=1)
        cube = np.clip(np.floor(centers + R0).astype(np.int64), 0, 2 * R0 - 1)
        sig = np.asarray(cond_field)[cube[:, 0], cube[:, 1], cube[:, 2]]
        mass, S, f, rnodes = reference_matrices(refinements)
        scale = 1 << refinements
        dev, dt = torch.device(device), dtype
        self.dtype, self.device = dt, dev
        t = lambda a, d=dt: torch.as_tensor(np.ascontiguousarray(a), device=dev).to(d)
        # element coefficients of A_e = sum_kl K_e[k, l] S[k, l], K_e =
        # |det J| J^-1 diag(sigma_e) J^-T
        K = detJ[:, None, None] * np.einsum("ekm,em,elm->ekl", Jinv, sig, Jinv)
        self.K = t(K.reshape(-1, 9))
        self.S = t(S.reshape(9, *S.shape[2:]))
        self.mass = t(mass)
        self.detJ = t(detJ)
        # the rhs of -div(sigma grad u) = div(sigma xi): b0_e = -|det J| f J^-1 (sigma xi)
        P = -detJ[:, None] * np.einsum("ekm,em->ek", Jinv, sig * np.asarray(xi)[None, :])
        self.b0e = t(P @ f.T)
        # lattice index of every (element, reference node), integer
        # arithmetic on the device
        q = torch.as_tensor(np.rint(rnodes * scale).astype(np.int64), device=dev)
        lat = torch.as_tensor(np.rint((v0 + R0) * scale).astype(np.int64), device=dev)[:, None, :] \
            + (torch.as_tensor(np.rint(J).astype(np.int64), device=dev)[:, None, :, :]
               * q[None, :, None, :]).sum(-1)
        m = 2 * R0 * scale + 1
        self.keys = (lat[..., 0] * m + lat[..., 1]) * m + lat[..., 2]
        del lat
        i = np.arange(m)
        inner = (i > 0) & (i < m - 1)
        self.interior = t(inner[:, None, None] & inner[None, :, None] & inner[None, None, :],
                          torch.bool).reshape(-1)
        self.N = m**3
        self.center_norm = np.abs(centers).max(axis=1)
        self.quirk = bool(np.allclose(detJ, 1.0))
        diag = self.scatter(self.detJ[:, None] * torch.diagonal(self.mass)[None, :])
        self.inv_diag = torch.where(self.interior, 1.0 / diag, torch.zeros_like(diag))

    def astype(self, dtype):
        """The same problem computing in ``dtype`` (the tables shared)."""
        other = copy.copy(self)
        other.dtype = dtype
        for name in ("K", "S", "mass", "detJ", "b0e", "inv_diag"):
            setattr(other, name, getattr(self, name).to(dtype))
        return other

    def scatter(self, ye):
        """Assembled global vector of element contributions, interior rows
        (boundary rows zero)."""
        out = torch.zeros(self.N, dtype=ye.dtype, device=self.device)
        out.index_add_(0, self.keys.reshape(-1), ye.reshape(-1))
        return out * self.interior

    def A(self, x):
        xe = x[self.keys]
        y = torch.zeros_like(xe)
        for p in range(9):
            y += self.K[:, p, None] * (xe @ self.S[p])
        return self.scatter(y)

    def M(self, x):
        return self.scatter(self.detJ[:, None] * (x[self.keys] @ self.mass))

    def msolve(self, b, tol=1e-12, maxiter=400):
        """Jacobi-preconditioned CG on M, stopped on the true residual
        ||r|| <= tol ||r_0||; (x, M applies)."""
        x = torch.zeros_like(b)
        r = b.clone()
        z = r * self.inv_diag
        p = z.clone()
        rz = torch.dot(r, z)
        eps2 = tol**2 * float(torch.dot(r, r))
        for it in range(1, maxiter + 1):
            Ap = self.M(p)
            alpha = rz / torch.dot(p, Ap)
            x += alpha * p
            r -= alpha * Ap
            if float(torch.dot(r, r)) <= eps2:
                return x, it + 1
            z = r * self.inv_diag
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        return x, maxiter + 1

    def sigma(self, lanczos_iters):
        """(sigma, sigma_steps, Lanczos steps, M applies)."""
        dt = self.dtype
        m_applies = 0
        b0c = self.scatter(self.b0e)
        q0, it = self.msolve(b0c)
        m_applies += it
        beta0 = math.sqrt(float(torch.dot(q0, self.M(q0))))
        V = torch.empty((lanczos_iters, self.N), dtype=dt, device=self.device)
        V[0] = q0 / beta0
        del q0
        alphas, betas = [], []
        beta_j = 0.0
        for j in range(lanczos_iters):
            v = V[j]
            u, it = self.msolve(self.A(v))
            m_applies += it
            alpha = float(torch.dot(u, self.M(v)))
            u -= alpha * v
            if j > 0:
                u -= beta_j * V[j - 1]
            beta_next = math.sqrt(max(float(torch.dot(u, self.M(u))), 0.0))
            alphas.append(alpha)
            if beta_next <= 1e-300 or j + 1 == lanczos_iters:
                break
            betas.append(beta_next)
            V[j + 1] = u / beta_next
            beta_j = beta_next
        m = len(alphas)
        T = np.diag(alphas) + np.diag(betas[: m - 1], 1) + np.diag(betas[: m - 1], -1)
        e1 = np.zeros(m)
        e1[0] = beta0
        lam = 1.0
        ys = [np.linalg.solve(T + lam * np.eye(m), e1)]
        for k in range(self.n + 1):
            lam /= 2.0
            if box_radius(k + 1, self.n) + boundary_layer(lam, self.n) > self.R0:
                break
            ys.append(lam * np.linalg.solve(T + lam * np.eye(m), ys[-1]))
        Y = torch.as_tensor(np.stack(ys), device=self.device).to(dt)
        vks = Y @ V[:m]
        del V
        sigma, steps, v_prev = 0.0, [], None
        mass_total = float(self.mass.sum())
        for k in range(len(ys)):
            xe = vks[k][self.keys]
            mask = torch.as_tensor(self.center_norm <= box_radius(k, self.n),
                                   device=self.device).to(dt)
            area = mass_total * float((self.detJ * mask).sum())
            Mx = xe @ self.mass
            if k == 0:
                a = (xe * Mx).sum(dim=1)
                b = (xe * self.b0e).sum(dim=1)
                s = self.detJ * (a + b) if self.quirk else b + self.detJ * a
            else:
                s = self.detJ * ((xe + v_prev) * Mx).sum(dim=1)
            sigma += 2.0**k * float((s * mask).sum()) / area
            steps.append(sigma)
            v_prev = xe
        return sigma, steps, m, m_applies
