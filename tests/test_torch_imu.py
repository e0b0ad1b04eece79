"""The port's IMU solver (`rgbd_odometry_tpu_torch/solvers/imu.py`; on CPU
tensors `kernels/imu.imu_scan` runs its plain version) against the JAX
package on the CPU: dead reckoning over 400 samples, preintegration with
noise, composition against the dead reckoner (JAX's own setup), the pose
information, the IMU edges, the velocities and `refine_trajectory_with_imu`;
the scan's plain version over B = 29 windows of 1, 37 and 4000 samples.
Inputs are made from seeds with numpy and handed to both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.pipeline.fused import refine_trajectory_with_imu as jax_refine  # noqa: E402
from rgbd_odometry_tpu.solvers import imu as jimu  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import imu as kimu  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.fused import refine_trajectory_with_imu  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import imu as pimu  # noqa: E402


def _window(rng, n, accel_scale=2.0, gyro_scale=0.8):
    return (rng.normal(0.0, accel_scale, (n, 3)).astype(np.float32),
            rng.normal(0.0, gyro_scale, (n, 3)).astype(np.float32))


def _state(rng):
    q = rng.normal(size=4).astype(np.float32)
    q = q / np.linalg.norm(q)
    p = rng.normal(0.0, 0.5, 3).astype(np.float32)
    v = rng.normal(0.0, 0.3, 3).astype(np.float32)
    return (jimu.ImuState(p=jnp.asarray(p), v=jnp.asarray(v), q=jnp.asarray(q)),
            pimu.ImuState(p=torch.from_numpy(p), v=torch.from_numpy(v), q=torch.from_numpy(q)))


def _intr(**kw):
    return jimu.ImuIntrinsics.from_scalars(**kw), pimu.ImuIntrinsics.from_scalars(device="cpu", **kw)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


CASES = {
    "gravity": dict(bias={}, gravity=jimu.DEFAULT_GRAVITY),
    "biases_and_gravity": dict(bias=dict(accel_bias=0.03, gyro_bias=-0.01),
                               gravity=jimu.DEFAULT_GRAVITY),
    "biases_no_gravity": dict(bias=dict(accel_bias=-0.2, gyro_bias=0.05), gravity=(0.0, 0.0, 0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_propagate_batch_400_samples_matches_jax(case):
    """Dead reckoning over 400 samples (p reaches 78 m under gravity): from
    the identity (the `imu` command's start) every state of the trajectory
    within 1e-6 of JAX's; from a random state within 1e-6 of each
    quantity's largest magnitude (PERF.md section 6: XLA:CPU contracts the
    fused quaternion update by an order that depends on the fusion, and the
    ulps it leaves in q are integrated with the rotated gravity)."""
    rng = np.random.default_rng(len(case))
    a, w = _window(rng, 400)
    ji, pi = _intr(**CASES[case]["bias"])
    g = CASES[case]["gravity"]
    start = (jimu.ImuState.identity(), pimu.ImuState.identity(device="cpu"))
    for (js, ps), relative in ((start, False), (_state(rng), True)):
        jf, jt = jimu.propagate_batch(js, jnp.asarray(a), jnp.asarray(w), ji, gravity=g)
        pf, pt = pimu.propagate_batch(ps, torch.from_numpy(a), torch.from_numpy(w), pi, gravity=g)
        for x, y in zip(tuple(jt) + tuple(jf), tuple(pt) + tuple(pf)):
            x, y = _np(x), _np(y)
            bar = 1e-6 * max(1.0, np.abs(x).max()) if relative else 1e-6
            assert np.abs(y - x).max() <= bar, (relative, np.abs(y - x).max())
    assert pt.p.shape == (400, 3) and pt.q.shape == (400, 4)


def test_propagate_windows_are_independent_and_step_is_one_sample():
    """B windows in one `imu_scan` equal each window run alone, bit for bit,
    and `propagate_step` is a window of one sample (JAX's step, 1e-6)."""
    rng = np.random.default_rng(4)
    A = rng.normal(0, 2, (3, 50, 3)).astype(np.float32)
    W = rng.normal(0, 0.8, (3, 50, 3)).astype(np.float32)
    _, pi = _intr(accel_bias=0.1, gyro_bias=0.02)
    s0 = pimu.ImuState.identity(device="cpu")
    batch = pimu.ImuState(*(x.expand(3, -1) for x in s0))
    _, bt = pimu.propagate_batch(batch, torch.from_numpy(A), torch.from_numpy(W), pi)
    for b in range(3):
        _, one = pimu.propagate_batch(s0, torch.from_numpy(A[b]), torch.from_numpy(W[b]), pi)
        for x, y in zip(bt, one):
            assert torch.equal(x[b], y)
    js, ps = _state(rng)
    ji, pi = _intr(accel_bias=0.1, gyro_bias=0.02)
    jn = jimu.propagate_step(js, jnp.asarray(A[0, 0]), jnp.asarray(W[0, 0]), ji)
    pn = pimu.propagate_step(ps, torch.from_numpy(A[0, 0]), torch.from_numpy(W[0, 0]), pi)
    for x, y in zip(jn, pn):
        np.testing.assert_allclose(_np(y), _np(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 10, 60])
def test_preintegrate_with_noise_matches_jax(n):
    """Preintegration with accelerometer and gyro noise: dR, dv, dp within
    1e-6 of JAX's, the 9x9 covariance within 1e-5 of its largest entry,
    dt_total exact; B windows in one launch equal each alone."""
    rng = np.random.default_rng(n)
    a, w = _window(rng, n)
    ji, pi = _intr(accel_var=0.08 ** 2, gyro_var=0.02 ** 2, accel_bias=0.03, gyro_bias=-0.01)
    jp = jimu.preintegrate(jnp.asarray(a), jnp.asarray(w), ji)
    pp = pimu.preintegrate(torch.from_numpy(a), torch.from_numpy(w), pi)
    for name in ("dR", "dv", "dp"):
        np.testing.assert_allclose(_np(getattr(pp, name)), _np(getattr(jp, name)), rtol=0,
                                   atol=1e-6)
    assert float(pp.dt_total) == float(jp.dt_total)
    cj = _np(jp.cov)
    assert np.abs(_np(pp.cov) - cj).max() <= 1e-5 * np.abs(cj).max()
    A2 = np.stack([a, a[::-1].copy()])
    W2 = np.stack([w, -w])
    pb = pimu.preintegrate(torch.from_numpy(A2), torch.from_numpy(W2), pi)
    for x, y in zip(pb, pp):
        assert torch.equal(x[0], y)


def test_compose_matches_dead_reckoner():
    """JAX's `test_compose_matches_dead_reckoner` on the port: composing a
    preintegrated window onto a start state equals propagating the window
    (JAX's bars, 2e-4 on p and v, 2e-5 on the rotation), and the composed
    state is within 1e-6 of JAX's."""
    rng = np.random.default_rng(7)
    ji, pi = _intr(accel_bias=0.03, gyro_bias=-0.01)
    for _ in range(4):
        a, w = _window(rng, 60)
        js, ps = _state(rng)
        direct, _ = pimu.propagate_batch(ps, torch.from_numpy(a), torch.from_numpy(w), pi)
        composed = pimu.compose_preintegrated(
            ps, pimu.preintegrate(torch.from_numpy(a), torch.from_numpy(w), pi))
        np.testing.assert_allclose(composed.p.numpy(), direct.p.numpy(), rtol=0, atol=2e-4)
        np.testing.assert_allclose(composed.v.numpy(), direct.v.numpy(), rtol=0, atol=2e-4)
        Rc, _ = pimu.pose_of(composed)
        Rd, _ = pimu.pose_of(direct)
        np.testing.assert_allclose(Rc.numpy(), Rd.numpy(), rtol=0, atol=2e-5)
        jc = jimu.compose_preintegrated(
            js, jimu.preintegrate(jnp.asarray(a), jnp.asarray(w), ji))
        for x, y in zip(jc, composed):
            np.testing.assert_allclose(_np(y), _np(x), rtol=0, atol=1e-6)


def test_information_edges_velocities_and_helpers_match_jax():
    """The pose information of noisy windows within 1e-5 of its largest
    entry (inverted covariances; JAX's layout), the IMU edges' R_rel and
    t_rel within 1e-6, the central-difference velocities within 1e-6, the
    right Jacobian and the rotation-vector quaternion within 1e-7, the
    Hamilton product of quaternions of norm ~2 within 1e-6 (JAX's eager
    call rounds each product, the port fuses them as XLA's compiled loops
    do: an ulp)."""
    rng = np.random.default_rng(23)
    E, n = 5, 25
    A = rng.normal(0, 1.5, (E, n, 3)).astype(np.float32)
    W = rng.normal(0, 0.4, (E, n, 3)).astype(np.float32)
    ji, pi = _intr(accel_var=1e-4, gyro_var=1e-5)
    pp = pimu.preintegrate(torch.from_numpy(A), torch.from_numpy(W), pi)
    jps = [jimu.preintegrate(jnp.asarray(A[e]), jnp.asarray(W[e]), ji) for e in range(E)]
    jp = jimu.Preintegrated(*(jnp.stack(xs) for xs in zip(*jps)))
    Ij = np.stack([np.asarray(jimu.preintegrated_pose_information(x)) for x in jps])
    Ip = pimu.preintegrated_pose_information(pp).numpy()
    assert np.abs(Ip - Ij).max() <= 1e-5 * np.abs(Ij).max()
    Rn = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, 0.3, (E, 3)).astype(np.float32))))
    vn = rng.normal(0, 0.5, (E, 3)).astype(np.float32)
    idx = np.arange(E, dtype=np.int32)
    je = jimu.imu_relative_pose_edges(jnp.asarray(idx), jnp.asarray(idx + 1), jnp.asarray(Rn),
                                      jnp.asarray(vn), jp, gravity=jimu.DEFAULT_GRAVITY,
                                      weight=2.0)
    pe = pimu.imu_relative_pose_edges(torch.from_numpy(idx), torch.from_numpy(idx + 1),
                                      torch.from_numpy(Rn), torch.from_numpy(vn), pp,
                                      gravity=jimu.DEFAULT_GRAVITY, weight=2.0)
    np.testing.assert_allclose(pe.R_rel.numpy(), np.asarray(je.R_rel), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pe.t_rel.numpy(), np.asarray(je.t_rel), rtol=0, atol=1e-6)
    assert pe.i.tolist() == idx.tolist() and pe.j.tolist() == (idx + 1).tolist()
    assert np.all(pe.weight.numpy() == 2.0) and pe.sqrt_info is None
    stamps = (np.arange(20) * 0.25).astype(np.float32)
    t = np.stack([np.sin(0.4 * stamps), 0.3 * stamps, np.cos(0.4 * stamps)], 1).astype(np.float32)
    vj = np.asarray(jimu.velocities_from_trajectory(jnp.asarray(t), jnp.asarray(stamps)))
    vp = pimu.velocities_from_trajectory(torch.from_numpy(t), torch.from_numpy(stamps)).numpy()
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-6)
    phi = (rng.normal(0, 1, (4, 3)) * np.array([[1e-7], [1e-3], [0.3], [1.5]])).astype(np.float32)
    for k in range(4):
        np.testing.assert_allclose(pimu._so3_right_jacobian(torch.from_numpy(phi[k])).numpy(),
                                   np.asarray(jimu._so3_right_jacobian(jnp.asarray(phi[k]))),
                                   rtol=0, atol=1e-7)
    np.testing.assert_allclose(pimu._quat_from_rotvec(torch.from_numpy(phi)).numpy(),
                               np.asarray(jimu._quat_from_rotvec(jnp.asarray(phi))), rtol=0,
                               atol=1e-7)
    qa = rng.normal(size=(6, 4)).astype(np.float32)
    qb = rng.normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_allclose(pimu._quat_mul(torch.from_numpy(qa), torch.from_numpy(qb)).numpy(),
                               np.asarray(jimu._quat_mul(jnp.asarray(qa), jnp.asarray(qb))),
                               rtol=0, atol=1e-6)


def _refine_case(rng, n=12, dt=1.0 / 30.0):
    """JAX's `test_refine_trajectory_with_imu` setup: a GT chain, a drifted
    visual estimate and exact gravity-free 1-sample windows from rest."""
    gt_R, gt_t, rels = [np.eye(3)], [np.zeros(3)], []
    for _ in range(n - 1):
        psi = np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.008, 3)])
        Rr, tr = jgeo.se3_exp(jnp.asarray(psi, jnp.float32))
        rels.append((np.asarray(Rr, np.float64), np.asarray(tr, np.float64)))
        gt_R.append(gt_R[-1] @ rels[-1][0])
        gt_t.append(gt_t[-1] + gt_R[-2] @ rels[-1][1])
    est_R, est_t = [gt_R[0]], [gt_t[0]]
    for Rr, tr in rels:
        dpsi = np.concatenate([rng.normal(0, 0.004, 3), rng.normal(0, 0.003, 3)])
        Rn, tn = jgeo.se3_exp(jnp.asarray(dpsi, jnp.float32))
        est_R.append(est_R[-1] @ (Rr @ np.asarray(Rn, np.float64)))
        est_t.append(est_t[-1] + est_R[-2] @ (tr + np.asarray(tn, np.float64)))
    windows = {}
    for k, (Rr, tr) in enumerate(rels, start=1):
        w = np.asarray(jgeo.so3_log(jnp.asarray(Rr, jnp.float32))) / dt
        windows[k] = ((2.0 * tr / (dt * dt))[None, :].astype(np.float32),
                      w[None, :].astype(np.float32), dt)
    return np.stack(gt_t), np.stack(est_R), np.stack(est_t), windows, np.arange(n) * dt


@pytest.mark.parametrize("weighted", [True, False])
def test_refine_trajectory_with_imu_matches_jax(weighted):
    """`refine_trajectory_with_imu` on JAX's setup (zero-noise windows,
    information weighted or scalar, and a noisy second pass with windows of
    two lengths, which preintegrate as two launches): the refined poses
    within 1e-5 of JAX's (the bar the port's pose graph holds), and the
    refinement pulls the drifted trajectory toward the ground truth."""
    rng = np.random.default_rng(31)
    gt_t, est_R, est_t, windows, stamps = _refine_case(rng)
    ji, pi = _intr()
    kw = dict(gravity=(0.0, 0.0, 0.0), velocities=np.zeros_like(est_t), imu_weight=5.0,
              information_weighted=weighted)
    Rj, tj = jax_refine(est_R, est_t, stamps, windows, ji, **kw)
    Rp, tp = refine_trajectory_with_imu(est_R, est_t, stamps, windows, pi, device="cpu", **kw)
    np.testing.assert_allclose(Rp, Rj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-5)
    err = lambda t: float(np.mean(np.linalg.norm(t - gt_t, axis=1)))  # noqa: E731
    assert err(tp) < 0.6 * err(est_t)
    # noisy windows of 1 and 3 samples, velocities from the trajectory
    ji, pi = _intr(accel_var=0.01, gyro_var=1e-4)
    for k in range(2, len(stamps), 2):
        a, w, d = windows[k]
        windows[k] = (np.repeat(a, 3, 0) / 9.0, np.repeat(w, 3, 0) / 3.0, d / 3.0)
    kw.pop("velocities")
    Rj, tj = jax_refine(est_R, est_t, stamps, windows, ji, **kw)
    Rp, tp = refine_trajectory_with_imu(est_R, est_t, stamps, windows, pi, device="cpu", **kw)
    np.testing.assert_allclose(Rp, Rj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-5)


def test_imu_scan_checks_its_device_and_mode():
    """The wrapper runs the plain version only for CPU tensors: another
    device, or an unknown mode on the card's path, raises."""
    a = torch.zeros((1, 2, 3), device="meta")
    p = torch.zeros(kimu.PARAMS, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kimu.imu_scan(kimu.PROPAGATE, a, a, p, 0.01, torch.zeros((1, 10), device="meta"))
    assert kimu.imu_scan.launches == 0


def _windows29(n):
    """29 windows of n samples and 29 random start states, numpy float32."""
    rng = np.random.default_rng(n)
    a = rng.normal(0.0, 2.0, (29, n, 3)).astype(np.float32)
    w = rng.normal(0.0, 0.8, (29, n, 3)).astype(np.float32)
    q = rng.normal(size=(29, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    p, v = (rng.normal(0.0, s, (29, 3)).astype(np.float32) for s in (0.5, 0.3))
    return a, w, (p, v, q)


@pytest.mark.parametrize("n", [1, 37, 4000])
def test_propagate_windows_of_any_length_match_jax(n):
    """`propagate_batch` over B = 29 windows of n samples from random
    states (the kernel's chunks are 64 samples, so 1 and 37 are one short
    chunk and 4000 is 62 chunks and a short one) against JAX's vmapped
    `propagate_batch`: every state within 1e-6 of each quantity's largest
    magnitude up to 37 samples (the bar of the 400-sample test). Over 4000
    samples the two float32 chains part further (XLA:CPU's order of the
    fused quaternion update leaves an ulp in q now and then, and p
    integrates it under gravity for 40 s): there the port must be no
    further from the float64 trajectory (JAX under `enable_x64`) than twice
    JAX's own distance, and within 1e-5 of JAX relative."""
    a, w, (p, v, q) = _windows29(n)
    ji, pi = _intr(accel_bias=0.03, gyro_bias=-0.01)
    run = jax.vmap(lambda s, a, w: jimu.propagate_batch(s, a, w, ji))
    _, jt = run(jimu.ImuState(p=jnp.asarray(p), v=jnp.asarray(v), q=jnp.asarray(q)),
                jnp.asarray(a), jnp.asarray(w))
    _, pt = pimu.propagate_batch(
        pimu.ImuState(p=torch.from_numpy(p), v=torch.from_numpy(v), q=torch.from_numpy(q)),
        torch.from_numpy(a), torch.from_numpy(w), pi)
    assert pt.p.shape == (29, n, 3) and pt.q.shape == (29, n, 4)
    rel = max(np.abs(_np(y) - _np(x)).max() / max(1.0, np.abs(_np(x)).max())
              for x, y in zip(jt, pt))
    if n <= 400:
        assert rel <= 1e-6
        return
    assert rel <= 1e-5
    with jax.enable_x64():
        ji64 = jimu.ImuIntrinsics.from_scalars(accel_bias=0.03, gyro_bias=-0.01)
        ji64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), ji64)
        f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
        _, t64 = jax.vmap(lambda s, a, w: jimu.propagate_batch(s, a, w, ji64))(
            jimu.ImuState(p=f64(p), v=f64(v), q=f64(q)), f64(a), f64(w))
        t64 = [np.asarray(x) for x in t64]
    for x64, x, y in zip(t64, jt, pt):
        assert np.abs(_np(y) - x64).max() <= 2.0 * np.abs(_np(x) - x64).max()


@pytest.mark.parametrize("n", [1, 37, 4000])
def test_preintegrate_windows_of_any_length_match_jax(n):
    """`preintegrate` over B = 29 windows of n samples (the kernel's chunks
    are 32 samples) against JAX's vmapped `preintegrate`: dR, dv and dp
    within 1e-6 of each quantity's largest magnitude (at 4000 samples dp
    reaches ~100 m, where 1e-6 absolute is below an ulp), the covariance
    within 1e-5 of its largest entry."""
    a, w, _ = _windows29(n)
    ji, pi = _intr(accel_var=0.08 ** 2, gyro_var=0.02 ** 2, accel_bias=0.03, gyro_bias=-0.01)
    jp = jax.vmap(lambda a, w: jimu.preintegrate(a, w, ji))(jnp.asarray(a), jnp.asarray(w))
    pp = pimu.preintegrate(torch.from_numpy(a), torch.from_numpy(w), pi)
    for name in ("dR", "dv", "dp"):
        x, y = _np(getattr(jp, name)), _np(getattr(pp, name))
        assert np.abs(y - x).max() <= 1e-6 * max(1.0, np.abs(x).max()), name
    cj = _np(jp.cov)
    assert pp.cov.shape == (29, 9, 9)
    assert np.abs(_np(pp.cov) - cj).max() <= 1e-5 * np.abs(cj).max()
