#!/usr/bin/env python
"""Boolean least squares:  minimize ||Ax - b||^2  s.t.  x_i^2 == 1.

Mirrors the reference example (reference: examples/boolean_least_squares.py)
on the batched JAX stack: same problem, same method chains, plus the batched
multi-restart solve the reference lacks.
"""
import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import qcqp_tpu as qt

n, m = 10, 15
np.random.seed(1)

A = np.random.randn(m, n)
b = np.random.randn(m, 1).ravel()

x = qt.Variable(n)
obj = qt.sum_squares(A @ x - b)
cons = [qt.square(x) == 1]
prob = qt.Problem(qt.Minimize(obj), cons)
qcqp = qt.QCQP(prob)

# Gaussian-round a candidate from the Shor relaxation
qcqp.suggest(qt.SDR)
print("Lower bound from the Shor relaxation: %.3f" % qcqp.sdr_bound)

f_cd, v_cd = qcqp.improve(qt.COORD_DESCENT)
x_cd = x.value
print("coord-descent    f=%.3f  maxviol=%.3f" % (f_cd, v_cd))

# the handler keeps the relaxation solution around, so this only re-samples
qcqp.suggest(qt.SDR)
f_dccp, v_dccp = qcqp.improve(qt.DCCP)
print("penalty-CCP      f=%.3f  maxviol=%.3f" % (f_dccp, v_dccp))
f_dccp, v_dccp = qcqp.improve(qt.COORD_DESCENT, phase1=False)
print("penalty-CCP then coord-descent   f=%.3f  maxviol=%.3f"
      % (f_dccp, v_dccp))

qcqp.suggest(qt.SDR)
f_admm, v_admm = qcqp.improve(qt.COORD_DESCENT)
f_admm, v_admm = qcqp.improve(qt.ADMM, phase1=False)
print("coord-descent then consensus-ADMM   f=%.3f  maxviol=%.3f"
      % (f_admm, v_admm))

# Extra over the reference: 256 SDR-sampled restarts in one batched solve
f_best, v_best = qcqp.solve(num_restarts=256, suggest=qt.SDR,
                            improve=qt.COORD_DESCENT)
print("Best of 256 parallel restarts: objective %.3f, violation %.3f"
      % (f_best, v_best))
