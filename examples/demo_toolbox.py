"""Demo: the Tensor Toolbox class surface, end to end.

Mirrors the workflow style of the toolbox's own documentation scripts
(`other_methods/tensor_toolbox-v3.1/doc/*.m`, exercised in MATLAB via the
class library): build dense/sparse/Kruskal/Tucker/symmetric tensors through
`tritd_tpu.ops.classes`, run the headline algorithms through the class
face, and round-trip the matricized forms. Doubles as a smoke test that
the class surface composes with jit (every class is a pytree).

Run: python examples/demo_toolbox.py [--n 20] [--rank 3]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=20)
    p.add_argument("--rank", type=int, default=3)
    p.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    args = p.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from tritd_tpu.ops import cp_als, tucker_hooi
    from tritd_tpu.ops.classes import (
        KTensor,
        SpTensor,
        SymKTensor,
        SymTensor,
        Tensor,
    )
    from tritd_tpu.ops.symmetric import eig_sshopm

    rng = np.random.default_rng(0)
    n, r = args.n, args.rank

    # 1. Kruskal ground truth -> dense -> CP-ALS recovery (cp_als.m)
    kt = KTensor(
        [rng.standard_normal((n, r)).astype(np.float32) for _ in range(3)]
    ).normalize().arrange()
    x = kt.full()
    fit = cp_als(x.data, rank=r, max_iters=100, init="nvecs")
    rec = KTensor(fit["factors"], fit["weights"])
    rel = float((x - rec.full()).norm() / x.norm())
    print(f"cp_als through the class face: rel err {rel:.2e}, "
          f"score vs truth {float(kt.score(rec.normalize())):.3f}")

    # 2. Tucker-HOOI + ttensor algebra (tucker_als.m, @ttensor methods)
    tk = tucker_hooi(x.data, (r, r, r), max_iters=30)
    from tritd_tpu.ops.classes import TTensor

    tt = TTensor(tk["core"], tk["factors"])
    print(f"tucker_hooi core {tuple(tt.core.shape)}, "
          f"rel err {float((x - tt.full()).norm() / x.norm()):.2e}, "
          f"entry(1,2,3) {float(tt[1, 2, 3]):+.4f}")

    # 3. Sparse workflow: COO tensor, scatter ttm, sptenmat + matrix-free
    #    A*A'*x (@sptensor/ttm.m, @sptenmat/aatx.m)
    nnz = 5 * n
    coords = np.stack([rng.integers(0, n, nnz) for _ in range(3)], 1).astype(np.int32)
    sp = SpTensor(rng.standard_normal(nnz).astype(np.float32), coords, (n, n, n))
    u = rng.standard_normal((r, n)).astype(np.float32)
    dense_slab = sp.ttm(u, 0)
    am = sp.to_sptenmat((0,))
    v = rng.standard_normal(n).astype(np.float32)
    aatv = am.aatx(v)
    a_dense = np.asarray(am.double())
    err = float(np.abs(np.asarray(aatv) - a_dense @ (a_dense.T @ v)).max())
    print(f"sptensor.ttm -> {tuple(dense_slab.shape)}, "
          f"sptenmat.aatx matrix-free max err {err:.1e}, nnz={sp.nnz}")

    # 4. Symmetric eigenpair via SS-HOPM on a symtensor (eig_sshopm.m)
    a = Tensor(rng.standard_normal((8, 8, 8)).astype(np.float32)).symmetrize()
    sym = SymTensor(a.data, presymmetrized=True)
    res = eig_sshopm(sym.data, shift=2.0, key=jax.random.PRNGKey(0))
    lam, vec = res["eigval"], res["eigvec"]
    resid = float(jnp.linalg.norm(sym.ttsv(vec) - lam * vec))
    print(f"eig_sshopm: lambda {float(lam):+.4f}, ||Ax^2 - lam x|| {resid:.1e}, "
          f"converged={bool(res['converged'])}")

    # 5. Symmetric Kruskal objective surface (fg.m) — one gradient step
    model = SymKTensor(
        jnp.asarray(rng.standard_normal(2).astype(np.float32)),
        jnp.asarray(rng.standard_normal((8, 2)).astype(np.float32)),
        3,
    )
    data = model.fg_setup(sym)
    f0, g = model.fg(data)
    stepped = SymKTensor.from_vec(model.tovec() - 1e-3 * g, 8, 2, 3)
    f1, _ = stepped.fg(data)
    print(f"symktensor.fg: f {float(f0):.4f} -> {float(f1):.4f} after one "
          f"gradient step (must decrease: {bool(f1 < f0)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
