"""Method-constant registry.

Re-implementation of the reference registry
(reference: qcqp/settings.py:25-36): the same seven public method constants
plus the two new device-native methods this framework adds.
"""

RANDOM = "random"
SDR = "sdr"
SPECTRAL = "spectral"

suggest_methods = [RANDOM, SDR, SPECTRAL]

COORD_DESCENT = "coord-descent"
ADMM = "admm"
# The reference delegates these two to external packages (DCCP, PyIpopt).
# Here both are first-class, device-native jitted loops: DCCP -> penalty
# convex-concave (solvers/ccp.py), IPOPT -> augmented-Lagrangian polish
# (solvers/nlp.py).
DCCP = "dccp"
IPOPT = "ipopt"

improve_methods = [COORD_DESCENT, ADMM, DCCP, IPOPT]
