"""The port's Wine ABI (``repro_torch.core.wine``) on the CPU, at smoke width:
``tests/test_wine.py`` and ``tests/test_system.py::
test_wine_abi_uniform_across_families`` in the prefill and decode modes,
and the logits of a Wine step held against the reference's.

Parity: the reference's smoke params (``lm_init`` from PRNGKey(0)),
converted (``convert.params_from_jax``), are loaded into both packages'
adapters as the instance state; one seeded batch goes through both. The
reference compiles its step (XLA fuses elementwise chains and skips some
bf16 roundings the port performs), so logits agree within LOGIT_ATOL =
3e-2 at logit scale ~1, the limit ``tests/test_torch_lm.py`` states. The
MoE families (olmoe-1b-7b, deepseek-v2-236b) are not in the parity set:
the reference's compiled forward flips near-tied expert choices against
its own eager one (``tests/test_torch_lm.py``'s docstring), and a Wine step
is compiled.

Not ported, by name: ``test_train_instance_still_advances_state`` and the
train-mode system test (Wine's ``train`` mode: the port has no training
step; ``load`` raises ``NotImplementedError``) and
``test_wine_cache_persists_across_processes`` (the disk tier).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.core.backend import ArrayBackend as JArrayBackend
from repro.core.wine import WineAdapter as JWineAdapter
from repro.core.wine import WineApp as JWineApp
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core.backend import ArrayBackend
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.wine import WineAdapter, WineApp
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

CPU = "cpu"
LOGIT_ATOL = 3e-2
SHAPE = {"prefill": "prefill_32k", "decode": "decode_32k"}


@pytest.fixture()
def cache():
    return CompileCache()


def _adapter(cache):
    return WineAdapter(backend=ArrayBackend(cache=cache, device=CPU))


def _batch(adapter, app):
    specs = adapter.input_specs(app)
    return {k: torch.ones(v.shape, dtype=v.dtype) if v.dtype == torch.int32
            else torch.zeros(v.shape, dtype=v.dtype)
            for k, v in specs.items()}


def test_prefill_instance_runs_twice_without_clobbering_state(cache):
    adapter = _adapter(cache)
    app = WineApp(arch="qwen3-14b", mode="prefill", shape="prefill_32k",
                  smoke=True)
    inst = adapter.load(app)
    params_before = inst.state
    batch = _batch(adapter, app)
    out1 = inst.run(batch)
    assert isinstance(out1, tuple) and len(out1) == 2
    assert inst.state is params_before
    out2 = inst.run(batch)
    assert torch.equal(out1[0], out2[0])
    assert inst.state is params_before


def test_train_mode_is_not_ported(cache):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _adapter(cache).load(WineApp(arch="mamba2-1.3b", mode="train",
                                     shape="train_4k", smoke=True))


def test_decode_instance_advances_caches(cache):
    adapter = _adapter(cache)
    app = WineApp(arch="qwen3-14b", mode="decode", shape="decode_32k",
                  smoke=True)
    inst = adapter.load(app)
    batch = _batch(adapter, app)
    before = [b["attn"]["pos"].clone() for g in inst.state[1]
              for b in g.values() if "attn" in b]
    logits = inst.run(batch)
    assert logits.shape[0] == batch["tokens"].shape[0]
    params, caches = inst.state
    assert caches is not None
    after = [b["attn"]["pos"] for g in caches for b in g.values()
             if "attn" in b]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


def test_run_falls_back_to_lazy_jit_on_unforeseen_shapes(cache):
    """The executable is exact-signature; inputs off the declared specs
    (a final partial batch) get an executable of their own, not an
    error."""
    adapter = _adapter(cache)
    app = WineApp(arch="mamba2-1.3b", mode="prefill", shape="prefill_32k",
                  smoke=True)
    inst = adapter.load(app)
    specs = adapter.input_specs(app)
    half = {k: torch.ones((2,) + v.shape[1:], dtype=v.dtype)
            for k, v in specs.items()}
    logits, _ = inst.run(half)
    assert logits.shape[0] == 2 and bool(torch.isfinite(logits).all())
    assert inst.load_report["compile_source"] == "jit-fallback"


def test_wine_compiles_through_shared_cache(cache):
    app = WineApp(arch="qwen3-14b", mode="prefill", smoke=True)
    a1 = _adapter(cache)
    inst1 = a1.load(app)
    assert inst1.load_report["compile_source"] == "compiled"
    assert not inst1.load_report["compile_cached"]
    inst2 = a1.load(app, state=inst1.state)
    assert inst2.load_report["compile_source"] == "memory"
    assert inst2.load_report["compile_cached"]
    a2 = _adapter(cache)
    inst3 = a2.load(app, state=inst1.state)
    assert inst3.load_report["compile_source"] == "memory"


def test_adapter_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WineAdapter()
    assert WineAdapter(device=CPU).device.type == "cpu"


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_wine_abi_uniform_across_families(arch, mode):
    """One ABI for every family: load, run one step, finite logits of
    (batch, 1, vocab) from every architecture, in both modes."""
    adapter = WineAdapter(device=CPU)
    app = WineApp(arch=arch, mode=mode, shape=SHAPE[mode], smoke=True)
    inst = adapter.load(app)
    batch = _batch(adapter, app)
    out = inst.run(batch)
    logits = out[0] if mode == "prefill" else out
    assert logits.shape == (batch["tokens"].shape[0], 1, inst.cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all()), arch


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

PARITY = ("qwen3-14b", "mamba2-1.3b", "gemma2-27b", "whisper-base",
          "internvl2-76b")


def _seeded(specs, vocab, seed):
    r = np.random.default_rng(seed)
    out = {}
    for k, v in specs.items():
        if k == "positions":
            out[k] = np.full(v.shape, 3, np.int32)
        elif str(v.dtype).endswith("int32"):
            out[k] = r.integers(1, vocab, v.shape).astype(np.int32)
        else:
            out[k] = r.standard_normal(v.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", PARITY)
def test_logits_match_reference(arch, mode):
    import jax.numpy as jnp
    jcfg = jget(arch, smoke=True)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    japp = JWineApp(arch=arch, mode=mode, shape=SHAPE[mode], smoke=True)
    tapp = WineApp(arch=arch, mode=mode, shape=SHAPE[mode], smoke=True)
    jad = JWineAdapter(backend=JArrayBackend())
    tad = WineAdapter(device=CPU)
    raw = _seeded(jad.input_specs(japp), jcfg.vocab, seed=5)
    jspecs = jad.input_specs(japp)
    jbatch = {k: jnp.asarray(v, jspecs[k].dtype) for k, v in raw.items()}
    tbatch = {k: (torch.from_numpy(v) if v.dtype == np.int32 else
                  torch.from_numpy(np.asarray(jbatch[k], np.float32)).to(
                      torch.bfloat16)) for k, v in raw.items()}
    if mode == "prefill":
        jstate, tstate = jp, tp
    else:                           # zero KV rings of the smoke cell
        cell = tad._cell(tapp)
        jstate = (jp, jlm.cache_init(jcfg, cell.global_batch, cell.seq_len))
        tstate = (tp, tlm.cache_init(tapp_cfg(arch), cell.global_batch,
                                     cell.seq_len, CPU))
    jinst = jad.load(japp, state=jstate)
    tinst = tad.load(tapp, state=tstate)
    jout = jinst.run(jbatch)
    tout = tinst.run(tbatch)
    jl = np.asarray(jout[0] if mode == "prefill" else jout, np.float32)
    tl = (tout[0] if mode == "prefill" else tout).float().numpy()
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0,
                               err_msg=f"{arch} {mode}")


def tapp_cfg(arch):
    return tget(arch, smoke=True)
