"""Port parity: the IMAS IDS adapters (``io/imas_ids.py``).

``scpn_fusion_tpu_torch/io/imas_ids.py`` is a copy of the JAX package's
numpy-only module: it is held equal to its source text outside the import
lines.  Both seeds of ``fuzz/seeds/geqdsk`` (and a seeded small file) go
G-EQDSK -> ``equilibrium`` IDS -> G-EQDSK through either package with equal
results, the port's reader feeding the port; the transport-state IDS
writers give equal payloads on a seeded state; and both packages reject the
same malformed IDS with the same message.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch_parity import rng

from scpn_fusion_tpu.io import geqdsk as jgq
from scpn_fusion_tpu.io import imas_ids as jids
from scpn_fusion_tpu_torch.io import geqdsk as tgq
from scpn_fusion_tpu_torch.io import imas_ids as tids

ROOT = Path(__file__).resolve().parent.parent
SEEDS = sorted((ROOT / "fuzz" / "seeds" / "geqdsk").glob("*.geqdsk"))


# The port's lines that differ from the source outside the imports, each with
# the source line it stands for (None: the port adds it).  The IDS reader
# takes the device its tensors land on (the card by default, as JAX puts its
# arrays on its default device), and binds ``jnp`` to torch's array
# functions on that device.
PORT_ONLY = {
    '                                     state_cls=None, *, device="cuda"):':
        "                                     state_cls=None):",
    "    jnp = torch_arrays.on(device)": None,
}


def _code_lines(path: Path, port_only: dict | None = None) -> list[str]:
    lines = [line for line in path.read_text().splitlines()
             if not line.lstrip().startswith(("import ", "from "))]
    if port_only is None:
        return lines
    assert all(lines.count(line) == 1 for line in port_only)
    return [port_only.get(line, line) for line in lines if port_only.get(line, line) is not None]


def test_copy_equals_source_outside_imports():
    assert _code_lines(ROOT / "scpn_fusion_tpu_torch" / "io" / "imas_ids.py",
                       PORT_ONLY) == _code_lines(ROOT / "scpn_fusion_tpu" / "io" / "imas_ids.py")
    text = (ROOT / "scpn_fusion_tpu_torch" / "io" / "imas_ids.py").read_text()
    assert "jax" not in text.replace("jax arrays", "").replace("jnp", "")


def _assert_same(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _assert_same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _small():
    g = rng(2)
    kw = dict(description="case", nw=5, nh=4, rdim=4.0, zdim=3.0, rcentr=6.2, rleft=4.0,
              zmid=0.0, rmaxis=6.1, zmaxis=0.05, simag=-1.2, sibry=0.3, bcentr=5.3,
              current=1.5e7, fpol=g.random(5), pres=g.random(5), ffprime=g.random(5),
              pprime=g.random(5), qpsi=1.0 + g.random(5), psirz=g.random((4, 5)),
              rbdry=np.asarray([5.0, 7.0, 6.0]), zbdry=np.asarray([0.0, 0.5, 1.0]))
    return jgq.GEqdsk(**kw), tgq.GEqdsk(**kw)


@pytest.mark.parametrize("source", [*SEEDS, "small"], ids=lambda p: getattr(p, "stem", p))
def test_round_trip_matches_jax(source):
    if source == "small":
        ref_eq, eq = _small()
    else:
        ref_eq, eq = jgq.read_geqdsk(source), tgq.read_geqdsk(source)
    ref_ids = jids.geqdsk_to_equilibrium_ids(ref_eq, time_s=1.5, shot=7)
    ids = tids.geqdsk_to_equilibrium_ids(eq, time_s=1.5, shot=7)
    _assert_same(ids, ref_ids)
    ref_back, back = jids.equilibrium_ids_to_geqdsk(ref_ids), tids.equilibrium_ids_to_geqdsk(ids)
    assert isinstance(back, tgq.GEqdsk)
    for f in dataclasses.fields(ref_back):
        _assert_same(getattr(back, f.name), getattr(ref_back, f.name))


def test_transport_writers_match_jax():
    g = rng(3)
    nr = 11
    state = SimpleNamespace(**{k: g.random(nr) for k in ("te", "ti", "ne", "n_d", "n_t", "n_he",
                                                         "chi_i", "chi_e", "d_n", "q")},
                            z_eff=1.7)
    params = SimpleNamespace(rho=lambda dt: np.linspace(0.0, 1.0, nr, dtype=dt), ip_ma=15.0,
                             b0=5.3, r0=6.2, nr=nr)
    for name in ("transport_state_to_core_profiles", "transport_state_to_core_transport"):
        _assert_same(getattr(tids, name)(state, params, time_s=2.0),
                     getattr(jids, name)(state, params, time_s=2.0))
    _assert_same(tids.transport_state_to_summary(state, params, p_aux_mw=33.0),
                 jids.transport_state_to_summary(state, params, p_aux_mw=33.0))


def test_validation_rejects_like_jax():
    ref_eq, eq = _small()
    for mod, e in ((jids, ref_eq), (tids, eq)):
        ids = mod.geqdsk_to_equilibrium_ids(e)
        ids["time_slice"][0]["profiles_2d"][0]["psi"] = [[1.0, 2.0]]
        with pytest.raises(mod.ImasIdsError, match="row count"):
            mod.validate_equilibrium_ids(ids)
        with pytest.raises(mod.ImasIdsError, match="missing keys"):
            mod.validate_equilibrium_ids({"time": [0.0]})


def test_core_profiles_reader_returns_the_ports_state():
    """``core_profiles`` IDS -> the port's ``TransportState`` of tensors on the
    device asked for, equal to JAX's state read from the same IDS (float32,
    as JAX's); with no ``device`` the state lands on the card, and without a
    card the reader raises instead of falling back to the CPU."""
    import jax.numpy as jnp
    import torch

    from scpn_fusion_tpu.models.transport import solver as js
    from scpn_fusion_tpu_torch.models.transport import solver as ts

    ref_p = js.TransportParams(nr=11)
    p = ts.TransportParams(nr=11)
    state = js.run_transport(js.initial_state(ref_p, jnp.float64), jnp.asarray(0.05),
                             jnp.asarray(20.0), ref_p, 2)[0]
    ids = jids.transport_state_to_core_profiles(state, ref_p, time_s=1.0)
    ref = jids.core_profiles_to_transport_state(ids, ref_p)
    ours = tids.core_profiles_to_transport_state(ids, p, device="cpu")
    assert isinstance(ours, ts.TransportState)
    for name in ref._fields:
        got = getattr(ours, name)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32, name
        assert np.array_equal(got.numpy(), np.asarray(getattr(ref, name))), name
    del ids["profiles_1d"][0]["q"]          # q falls back to 1 + 2 rho^2, He to zero
    ids["profiles_1d"][0]["ion"] = ids["profiles_1d"][0]["ion"][:2]
    ref, ours = jids.core_profiles_to_transport_state(ids, ref_p), \
        tids.core_profiles_to_transport_state(ids, p, device="cpu")
    for name in ("q", "n_he"):
        assert np.array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    with pytest.raises(tids.ImasIdsError, match="params.nr"):
        tids.core_profiles_to_transport_state(ids, ts.TransportParams(nr=12), device="cpu")
    if torch.cuda.is_available():
        assert tids.core_profiles_to_transport_state(ids, p).ti.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tids.core_profiles_to_transport_state(ids, p)
