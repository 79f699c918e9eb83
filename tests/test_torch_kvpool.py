"""The port's radix-root fingerprint (``launch/kvpool.nldpe_fingerprint``)
held against ``repro``'s: nested config dataclasses flatten recursively
into a hashable key, so a config that grows a nested field still keys a
``PagePool`` root."""
import dataclasses

import pytest

from repro.core.engine import NLDPEConfig as JNLDPEConfig
from repro.launch.kvpool import nldpe_fingerprint as j_fingerprint

from repro_torch.core.engine import FUSED, OFF
from repro_torch.launch.kvpool import PagePool, nldpe_fingerprint


@dataclasses.dataclass(frozen=True)
class _Inner:
    bits: int = 8
    levels: tuple = (1.0, 2.0)


@dataclasses.dataclass(frozen=True)
class _Nested:
    enabled: bool = True
    logdomain: _Inner = _Inner()
    tables: list = dataclasses.field(default_factory=lambda: [_Inner(4)])


def test_nested_config_fingerprint_is_hashable_and_keys_a_root():
    """A stub config with nested dataclass fields (one inside a list): the
    key hashes, equals ``repro``'s, and ``PagePool`` publishes and matches
    under it; another nested value is another root."""
    fp = nldpe_fingerprint(_Nested(), "log8")
    hash(fp)
    assert fp == j_fingerprint(_Nested(), "log8")
    assert fp == (("kv_quant", "log8"), ("nldpe", (
        ("enabled", True),
        ("logdomain", (("bits", 8), ("levels", (1.0, 2.0)))),
        ("tables", ((("bits", 4), ("levels", (1.0, 2.0))),)))))
    pool = PagePool(num_pages=4, page_size=2)
    pages = pool.alloc(2)
    pool.publish(fp, (1, 2, 3, 4), pages)
    assert pool.match(fp, (1, 2, 3, 4, 5)) == pages
    other = nldpe_fingerprint(_Nested(logdomain=_Inner(bits=4)), "log8")
    assert other != fp and pool.match(other, (1, 2, 3, 4)) == []


@pytest.mark.parametrize("kv_quant", [None, "int8", "log8"])
@pytest.mark.parametrize("cfg", [OFF, FUSED], ids=["OFF", "FUSED"])
def test_fingerprint_matches_repro_structure(cfg, kv_quant):
    """The port's key for its own configs is ``repro``'s function on the
    same field values — and, now that the configs carry the same fields
    (the nested ``logdomain`` grids flattened too), ``repro``'s key for
    its own config — and distinct per grid and per config."""
    def flat(x):
        if dataclasses.is_dataclass(x):
            return tuple(sorted((f.name, flat(getattr(x, f.name)))
                                for f in dataclasses.fields(x)))
        return x

    fp = nldpe_fingerprint(cfg, kv_quant)
    assert fp == j_fingerprint(cfg, kv_quant)
    j_cfg = JNLDPEConfig(enabled=cfg.enabled,
                         fused_dual_compute=cfg.fused_dual_compute)
    assert fp == j_fingerprint(j_cfg, kv_quant)
    assert fp == (("kv_quant", kv_quant), ("nldpe", flat(cfg)))
    others = {nldpe_fingerprint(c, k) for c in (OFF, FUSED)
              for k in (None, "int8", "log8")}
    assert len(others) == 6
