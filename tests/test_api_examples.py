"""Golden end-to-end parity tests over the four reference examples.

The reference pins seeds and prints (objective, violation) per method
(reference: examples/*.py, all with np.random.seed(1)); since the reference
cannot run in this environment (CVXPY 0.4 + Py2), the golden values below were
produced by this framework's high-accuracy float64 path and are validated
structurally: bounds certified against brute force / analytic values, and
improved points checked feasible + not-worse under the `better` order.
"""

import numpy as np
import pytest

import qcqp_tpu as qt


def _boolean_ls():
    n, m = 10, 15
    np.random.seed(1)
    A = np.random.randn(m, n)
    b = np.random.randn(m, 1).ravel()
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    return prob, x, A, b


class TestBooleanLS:
    def test_full_reference_pipeline(self):
        prob, x, A, b = _boolean_ls()
        q = qt.QCQP(prob)
        q.suggest(qt.SDR)
        # golden: pinned from the float64 run; brute-force optimum is 35.550
        assert q.sdr_bound == pytest.approx(28.750, abs=2e-2)

        f_cd, v_cd = q.improve(qt.COORD_DESCENT)
        assert v_cd < 1e-2
        assert f_cd <= 40.0
        # x.value round-trips
        assert np.allclose(np.abs(np.asarray(x.value).ravel()), 1.0, atol=2e-2)

        # cached SDR: suggest again must not change the bound
        bound = q.sdr_bound
        q.suggest(qt.SDR)
        assert q.sdr_bound == bound

        f_ccp, v_ccp = q.improve(qt.DCCP)
        assert v_ccp < 1e-4
        f2, v2 = q.improve(qt.COORD_DESCENT, phase1=False)
        assert v2 < 1e-2

        q.suggest(qt.SDR)
        f3, _ = q.improve(qt.COORD_DESCENT)
        f4, v4 = q.improve(qt.ADMM, phase1=False)
        assert v4 < 1e-2
        assert f4 <= 40.0

    def test_batched_solve_finds_global_optimum(self):
        prob, x, A, b = _boolean_ls()
        best = np.inf
        for bits in range(1 << 10):
            s = np.array([1.0 if bits >> i & 1 else -1.0 for i in range(10)])
            best = min(best, float(np.sum((A @ s - b) ** 2)))
        q = qt.QCQP(prob)
        q.suggest(qt.SDR)
        f, v = q.solve(num_restarts=256, suggest=qt.SDR,
                       improve=qt.COORD_DESCENT)
        assert v < 1e-2
        assert f <= best + 1e-6  # 256 SDR restarts reach the global optimum

    def test_improve_without_suggest_auto_suggests(self):
        prob, x, _, _ = _boolean_ls()
        q = qt.QCQP(prob)
        f, v = q.improve(qt.COORD_DESCENT)  # must not crash (reference bug)
        assert np.isfinite(f)

    def test_report_is_one_host_read(self, monkeypatch):
        """suggest/improve pay exactly ONE device->host transfer each.
        Spy: count np.asarray conversions of device arrays inside the api
        module."""
        import jax
        import qcqp_tpu.api as api_mod
        prob, x, _, _ = _boolean_ls()
        q = qt.QCQP(prob)
        reads = []
        real_asarray = np.asarray

        def spy(a, *args, **kw):
            if isinstance(a, jax.Array):
                reads.append(a.shape)
            return real_asarray(a, *args, **kw)

        monkeypatch.setattr(api_mod.np, "asarray", spy)
        q.suggest(qt.RANDOM)
        assert len(reads) == 1 and reads[0] == (q.n + 2,)
        reads.clear()
        q.improve(qt.COORD_DESCENT)
        assert len(reads) == 1 and reads[0] == (q.n + 2,)

    def test_ipopt_slot(self):
        prob, x, _, _ = _boolean_ls()
        q = qt.QCQP(prob)
        q.suggest(qt.RANDOM)
        f, v = q.improve(qt.IPOPT)
        assert v < 1e-4


class TestMaxcut:
    def _prob(self):
        n = 25
        np.random.seed(1)
        p = 0.2
        W = np.random.uniform(low=0.0, high=1.0, size=(n, n))
        for i in range(n):
            W[i, i] = 1
            for j in range(i + 1, n):
                W[j, i] = W[i, j]
        W = (W < p).astype(float)
        x = qt.Variable(n)
        obj = 0.25 * (qt.sum_entries(W) - qt.quad_form(x, W))
        prob = qt.Problem(qt.Maximize(obj), [qt.square(x) == 1])
        return prob, x, W

    def test_bound_and_cd(self):
        prob, x, W = self._prob()
        q = qt.QCQP(prob)
        q.suggest(qt.SDR)
        # golden pinned value (maximization: upper bound)
        assert q.sdr_bound == pytest.approx(57.207, abs=5e-2)
        f_cd, v_cd = q.improve(qt.COORD_DESCENT)
        assert v_cd < 1e-2
        # a cut value is at most the bound (maximize sign convention)
        assert f_cd <= q.sdr_bound + 1e-6
        assert f_cd >= 45.0  # pinned regression floor (got 55.0)


class TestCirclePacking:
    def test_bound_is_analytic(self):
        n = 5
        B = 10.0
        X = qt.Variable(2, n)
        r = qt.Variable()
        cons = [X >= r, X <= B - r, r >= 0]
        for i in range(n):
            for j in range(i + 1, n):
                cons.append(qt.square(2 * r)
                            <= qt.sum_squares(X[:, i] - X[:, j]))
        prob = qt.Problem(qt.Maximize(r), cons)
        q = qt.QCQP(prob)
        q.suggest(qt.SDR)
        # radius can never exceed B/2; the SDR bound is exactly that here
        assert q.sdr_bound == pytest.approx(5.0, abs=2e-2)
        f, v = q.improve(qt.DCCP)
        assert v < 1e-4
        assert 0.5 <= f <= 5.0  # pinned regression floor (got 1.864)


class TestBeamforming:
    def test_pipeline(self):
        n, m, l = 20, 5, 2
        tau_, eta = 20.0, 2.0
        np.random.seed(1)
        HR = np.random.randn(m, n); HI = np.random.randn(m, n)
        A = np.hstack((HR, HI)); B_ = np.hstack((-HI, HR))
        GR = np.random.randn(l, n); GI = np.random.randn(l, n)
        C = np.hstack((GR, GI)); D = np.hstack((-GI, GR))
        x = qt.Variable(2 * n)
        prob = qt.Problem(
            qt.Minimize(qt.sum_squares(x)),
            [qt.square(A @ x) + qt.square(B_ @ x) >= tau_,
             qt.square(C @ x) + qt.square(D @ x) <= eta])
        q = qt.QCQP(prob)
        q.suggest(qt.SDR)
        # golden pinned value
        assert q.sdr_bound == pytest.approx(1.970, abs=2e-2)
        f, v = q.improve(qt.DCCP)
        assert v < 1e-4
        assert f <= 2.5  # CCP attains ~the bound (SDR tight here)
        f2, v2 = q.improve(qt.ADMM, rho=np.sqrt(m + l), phase1=False)
        assert np.isfinite(f2)

    def test_admm_rho_validation(self):
        # indefinite objective -> z-update nonconvex for tiny rho
        # (reference raises: qcqp/qcqp.py:261-268)
        x = qt.Variable(2)
        P = np.array([[1.0, 0.0], [0.0, -1.0]])
        prob = qt.Problem(qt.Minimize(qt.quad_form(x, P)),
                          [qt.sum_squares(x) <= 1])
        q = qt.QCQP(prob)
        q.suggest(qt.RANDOM)
        with pytest.raises(ValueError, match="rho"):
            q.improve(qt.ADMM, rho=1e-9)


class TestInfeasibleProblems:
    def test_suggest_sdr_raises_infeasible(self):
        """An infeasible user problem (contradictory equalities) surfaces a
        distinct classification through the public API — the failure
        semantics the reference delegated to its conic solvers
        (qcqp/qcqp.py:94-95); round-4 certificates."""
        x = qt.Variable(2)
        prob = qt.Problem(qt.Minimize(qt.sum_squares(x)),
                          [qt.square(x[0]) == 1,
                           qt.square(x[0]) == 4])
        q = qt.QCQP(prob, check_dcp=False)
        with pytest.raises(qt.InfeasibleRelaxationError):
            q.suggest(qt.SDR)


class TestUnconstrainedProblems:
    def test_all_improves_handle_m_equals_zero(self):
        """Consensus ADMM degenerates at m=0 (the reference divides by m
        and crashes, qcqp.py:205,277 — quirk not replicated): every improve
        method must handle an unconstrained problem."""
        x = qt.Variable(3)
        prob = qt.Problem(qt.Minimize(qt.sum_squares(x - np.ones(3))), [])
        q = qt.QCQP(prob, check_dcp=False)
        q.suggest(qt.RANDOM)
        for meth in (qt.COORD_DESCENT, qt.ADMM, qt.DCCP, qt.IPOPT):
            f, v = q.improve(meth)
            assert np.isfinite(f) and v == 0.0
            assert f <= 1e-3 or meth == qt.DCCP  # convex: reaches 0
