"""sid_tpu's device Nelder-Mead, the port's host loop and the port's step
machine (csrc/nmsimplex.cuh through its g++ shim) on the same objectives,
run in a subprocess:

    XLA_FLAGS=--xla_backend_optimization_level=0 JAX_PLATFORMS=cpu \
        python tests/torch_nm_jax_runs.py SHIM.so

XLA:CPU contracts mul+add chains into FMAs unless its backend optimization
is off (tests/nm_trace_tool.py), and the card's copy of the loop contracts
nothing, so the three are held to each other bitwise with it off. Each
objective is jitted once and every loop evaluates that one function. Prints
one JSON line a case: each loop's x and fval (as float.hex), iterations
and converged, the number of points the host loop and the shim visited and
whether those points are bitwise equal.
"""

import ctypes
import json
import sys

import numpy as np

DBL_MAX = float(np.finfo(np.float64).max)


def cases(jnp):
    """(name, objective, x0, step, max_iterations): nm_trace_tool's
    adversarial set, the lean loop's objectives from the fit's start, a run
    to max_iterations, and 1-D objectives (the pi fits)."""
    from nm_trace_tool import _make_objectives

    out = [(f.__name__, f, x0, step, 1000) for f, x0, step in _make_objectives(jnp)]
    start, step = [1e-3, 1e-3], [1e-4, 1e-4]
    out += [
        ("lean_rosenbrock", lambda th: (1 - th[0]) ** 2 + 100 * (th[1] - th[0] ** 2) ** 2, start, step, 1000),
        ("lean_quadratic", lambda th: jnp.sum((th - jnp.asarray([0.3, -0.7])) ** 2), start, step, 1000),
        ("lean_abs", lambda th: jnp.sum(jnp.abs(th - 0.12345)), start, step, 1000),
        ("lean_nan_region", lambda th: jnp.where(th[1] < -0.001, jnp.float64(jnp.nan), jnp.sum((th - 0.2) ** 2)),
         start, step, 1000),
        ("lean_inf_penalty", lambda th: jnp.where(jnp.abs(th[0]) > 0.05, jnp.inf, jnp.sum(th ** 2)), start, step,
         1000),
        ("unbounded", lambda th: th[0] + th[1], [0.0, 0.0], [1.0, 1.0], 1000),
        ("quad_7_iterations", lambda th: (th[0] - 3.0) ** 2 + 2.0 * (th[1] + 1.0) ** 2, [0.0, 0.0], [0.1, 0.1], 7),
        ("pi_quadratic", lambda th: (th[0] - 0.3) ** 2, [1e-3], [1e-4], 1000),
        ("pi_nan", lambda th: jnp.where(th[0] > 0.0015, jnp.nan, th[0] ** 2), [1e-3], [1e-4], 1000),
        ("pi_box", lambda th: jnp.where(th[0] < 0, DBL_MAX, jnp.abs(th[0] - 0.02)), [1e-3], [1e-4], 1000),
        ("pi_unbounded", lambda th: -th[0], [1e-3], [1e-4], 1000),
        ("pi_neg_inf", lambda th: jnp.where(th[0] > 0.01, -jnp.inf, th[0]), [1e-3], [1e-4], 1000),
        ("pi_quadratic_1_iteration", lambda th: (th[0] - 0.3) ** 2, [1e-3], [1e-4], 1),
        ("pi_quadratic_0_iterations", lambda th: (th[0] - 0.3) ** 2, [1e-3], [1e-4], 0),
    ]
    return out


def shim_minimize(lib, f, x0, step, max_iterations, dot_mode):
    """The step machine from x0: every point it asks for, evaluated by f;
    returns (points, x, fval, converged, iterations)."""
    n = len(x0)
    state = ctypes.create_string_buffer(lib.sid_nm_state_bytes(n))
    a = np.ascontiguousarray(x0, np.float64)
    b = np.ascontiguousarray(step, np.float64)
    lib.sid_nm_start(n, state, a.ctypes.data, b.ctypes.data, 1e-5, max_iterations, dot_mode)
    x = np.zeros(n)
    points = []
    while lib.sid_nm_pending(n, state, x.ctypes.data) != 5:
        points.append(x.copy())
        lib.sid_nm_take(n, state, f(x.copy()))
    out = np.zeros(n)
    fval, conv, it = ctypes.c_double(), ctypes.c_int(), ctypes.c_int()
    lib.sid_nm_result(n, state, out.ctypes.data, ctypes.byref(fval), ctypes.byref(conv), ctypes.byref(it))
    return points, out, fval.value, bool(conv.value), it.value


def load_shim(path):
    lib = ctypes.CDLL(path)
    p, d, i = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    for name, args, res in (("sid_nm_state_bytes", [i], i), ("sid_nm_start", [i, p, p, p, d, i, i], None),
                            ("sid_nm_pending", [i, p, p], i), ("sid_nm_take", [i, p, d], None),
                            ("sid_nm_result", [i, p, p, p, p, p], None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import sid_tpu  # noqa: F401  (enables x64)
    import jax.numpy as jnp

    from sid_tpu.ops.nmsimplex import minimize_nmsimplex2_jax
    from sid_tpu_torch.exact import nmsimplex

    lib = load_shim(sys.argv[1])
    mode = nmsimplex.dot_mode()
    for name, f, x0, step, max_it in cases(jnp):
        jf = jax.jit(f)
        fn = lambda x, _f=jf: float(_f(jnp.asarray(x, jnp.float64)))  # noqa: E731
        host_points = []
        host = nmsimplex.minimize_nmsimplex2(lambda x: host_points.append(np.array(x)) or fn(x), x0, step,
                                             max_iterations=max_it)
        points, sx, sf, sc, si = shim_minimize(lib, fn, x0, step, max_it, mode)
        jx = minimize_nmsimplex2_jax(jf, jnp.asarray(x0, jnp.float64), jnp.asarray(step, jnp.float64),
                                     max_iterations=max_it)
        row = {"name": name, "dims": len(x0)}
        for who, x, fv, conv, it in (("host", host.x, host.fval, host.converged, host.iterations),
                                     ("shim", sx, sf, sc, si),
                                     ("jax", np.asarray(jx.x), float(jx.fval), bool(jx.converged), int(jx.iterations))):
            row[who] = {"x": [float(v).hex() for v in x], "fval": float(fv).hex(), "converged": bool(conv),
                        "iterations": int(it)}
        row["points"] = len(points)
        row["points_equal"] = len(points) == len(host_points) and all(
            np.array_equal(p, q, equal_nan=True) for p, q in zip(points, host_points))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
