"""Why the JAX package's jitted ICP is not reproduced bit for bit: XLA:CPU
lowers a jitted 1/jnp.sqrt (the Kabsch's Givens rotations take it) to the
hardware's reciprocal square-root estimate followed by Newton steps, so
its float32 result depends on the CPU's estimate table.

    JAX_PLATFORMS=cpu python docs/studies/xla_rsqrt_study.py

dumps the optimized LLVM IR of jax.jit(lambda x: 1 / jnp.sqrt(x)) into a
temporary directory and prints the estimate intrinsic it calls and the
Newton step's operations; then, on 1,000,000 seeded float32 inputs in
[1, 5), the share of jitted results that differ from the correctly
rounded 1/sqrt, and the share that the same Newton steps, taken in
numpy float32 from a correctly rounded seed (and from seeds 2**-12 off
it), fail to reproduce.  A study run by hand, not a test.
"""

import os
import pathlib
import re
import sys
import tempfile

N_INPUTS = 1_000_000


def main() -> int:
    dump = tempfile.mkdtemp(prefix="xla_rsqrt_")
    os.environ["XLA_FLAGS"] = f"--xla_dump_to={dump}"
    import jax
    import jax.numpy as jnp
    import numpy as np

    f32 = np.float32
    x = np.random.default_rng(0).uniform(1.0, 5.0, N_INPUTS).astype(f32)
    jitted = np.asarray(jax.jit(lambda a: 1 / jnp.sqrt(a))(x))
    ir = "".join(p.read_text() for p in pathlib.Path(dump).glob(
        "*ir-with-opt.ll"))
    intrinsics = sorted(set(re.findall(r"@(llvm\.x86\.\w+\.rsqrt[\w.]*)",
                                       ir)))
    m = re.search(r"(%y_approx[\w.]*) = call .*?rsqrt.*?\n((?:.*\n){12})",
                  ir)
    print(f"jax {jax.__version__}, backend {jax.default_backend()}")
    print(f"estimate intrinsic(s) in the optimized IR: {intrinsics}")
    if m:
        print("the refinement after the first estimate:")
        for line in m.group(2).splitlines():
            print("   ", line.strip())

    def newton(y):
        # e = x*y; h = -0.5*y; y' = h*(e*y - 1) + y, each op rounded in
        # float32, as the IR above
        e = x * y
        h = y * f32(-0.5)
        return h * (e * y + f32(-1.0)) + y

    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(f32)
    print(f"jitted 1/sqrt != correctly rounded: "
          f"{np.mean(jitted != exact):.4f} of {N_INPUTS}")
    for label, seed in (("correctly rounded seed", exact),
                        ("seed * (1 + 2**-12)", exact * f32(1 + 2 ** -12)),
                        ("seed * (1 - 2**-12)", exact * f32(1 - 2 ** -12))):
        two = newton(newton(seed))
        print(f"two Newton steps from a {label} != jitted: "
              f"{np.mean(two != jitted):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
