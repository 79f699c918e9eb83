"""Quickstart: the NL-DPE kernel library of the port.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

The counterpart of ``examples/quickstart.py`` sections 1-3, plus an
analog-slicing section; it runs on the GPU unless ``--device cpu`` is
given (the kernels then take their plain versions).

1. Build the per-bit decision tree of GELU, map it to an ACAM table and
   evaluate it three ways: the hardware-faithful interval match, the
   compiled piecewise fast path and kernel D (``acam_apply``).
2. A log-domain DMMul (exp(log a + log b)) in ``nldpe_matmul``'s fused and
   exact modes and through kernel G (``nldpe_matmul_int8``), against a
   float32 matmul.
3. Bake one bad programming pass (6x the default noise) into the GELU
   table's thresholds (``corrupt_table``), then repair it with per-DT
   Noise-Aware Fine-tuning (``finetune_table``, Algorithm 1's surrogate
   under 2x noise; every evaluation through kernel D on the card).
4. Program a weight matrix with A-SL and programming noise
   (``program_linear``), then one crossbar pass with read noise through
   kernel E (``crossbar_matmul``), against the ideal VMM.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import resolve_device
from .core import acam, crossbar, dt, logdomain, noise
from .core.naf import corrupt_table, finetune_table
from .core.functions import TORCH_FUNCTIONS
from .kernels import acam_apply, crossbar_matmul, nldpe_matmul_int8
from .launch import prng


NAF_EPOCHS = 5          # section 3's fine-tuning epochs (the reference's)


def naf_section(table, dev) -> dict:
    """Section 3: bake a 6x-noise programming pass into ``table`` and
    repair it with per-DT NAF under 2x noise; returns the MSEs."""
    model = noise.DEFAULT.rescale(2.0)
    bad = corrupt_table(table, prng.prng_key(42), noise.DEFAULT.rescale(6.0),
                        device=dev)
    res = finetune_table(bad, rng=prng.prng_key(0), model=model,
                         epochs=NAF_EPOCHS, samples=2000, device=dev)
    print(f"ACAM persistent corruption: clean {res.mse_clean:.2e} -> "
          f"corrupted+noise {res.mse_before:.2e}; after NAF ({NAF_EPOCHS} "
          f"epochs): {res.mse_after:.2e}")
    return {"naf_mse_clean": res.mse_clean, "naf_mse_before": res.mse_before,
            "naf_mse_after": res.mse_after}


def main(device=None) -> dict:
    """Run the four sections on ``device`` (the GPU by default); prints
    their errors and returns them with the GELU outputs."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out = {}

    # -- 1. ACAM-computed GELU ------------------------------------------------
    table = dt.build_table("gelu", bits=8, encoding="gray")
    print(f"GELU DT -> ACAM: rows per bit (MSB..LSB) = "
          f"{list(reversed(table.rows_per_bit))}, total = {table.total_rows}")
    x = torch.from_numpy(rng.uniform(-6, 6, (4, 128)).astype(np.float32)
                         ).to(dev)
    ys = {"interval": acam.eval_acam(table, x),
          "piecewise": acam.acam_activation(x, "gelu"),
          "kernel": acam_apply(x, table)}
    ref = TORCH_FUNCTIONS["gelu"](x)
    for name, y in ys.items():
        mse = float(torch.mean((y - ref) ** 2))
        out[f"gelu_{name}_mse"] = mse
        print(f"  {name:9s} MSE vs fp32 gelu: {mse:.2e}")
    out["gelu"] = ys

    # -- 2. log-domain DMMul ------------------------------------------------
    a = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)).to(dev)
    exact = a @ b
    for name, c in (("fused", logdomain.nldpe_matmul(a, b)),
                    ("exact", logdomain.nldpe_matmul(a, b, mode="exact")),
                    ("kernel", nldpe_matmul_int8(a, b))):
        rel = float(torch.mean((c - exact) ** 2) / torch.var(exact))
        out[f"dmmul_{name}_rel_mse"] = rel
        print(f"DMMul exp(log+log) {name:6s}: relative MSE vs fp32 matmul "
              f"= {rel:.2e}")

    # -- 3. a bad programming pass breaks it; NAF repairs it --------------------
    out.update(naf_section(table, dev))

    # -- 4. A-SL crossbar with programming and read noise --------------------
    w = torch.from_numpy((rng.normal(size=(256, 128)) / 16).astype(
        np.float32)).to(dev)
    xw = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32)
                          ).to(dev)
    plan, eps = crossbar.program_linear(w, rng=prng.prng_key(1))
    y = crossbar_matmul(xw, plan, rng=prng.prng_key(2))
    ideal = crossbar.ideal_vmm(xw, w)
    rel = float(torch.mean((y - ideal) ** 2) / torch.var(ideal))
    out["asl_rel_mse"] = rel
    out["asl_max_eps"] = float(eps.max())
    print(f"A-SL crossbar (programming + read noise): relative MSE vs the "
          f"ideal VMM = {rel:.2e}; max |programming residual| "
          f"{out['asl_max_eps']:.2e}")
    print("quickstart OK")
    return out


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain versions)")
    main(p.parse_args(argv).device)


if __name__ == "__main__":
    cli()
