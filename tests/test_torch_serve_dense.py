"""Port vs reference: the dense family beyond gemma-2b served — yi-6b
(silu, untied embeddings, 4 query heads over 2 KV heads reduced, rope
theta 5e6), minitron-4b (the ungated squared-ReLU FFN) and yi-34b,
reduced to two layers, the reference's weights carried across
(`interop.model_params_from_jax`), prefill and decode over the tiered
KV cache under IPS_AGC (tests/test_torch_serve.py covers the four
policies on gemma-2b).

The spec is test_torch_serve.py's (hot window 16, page 8, group 16;
prompt 24), 32 decode steps, the port teacher-forced on the reference's
tokens: the prefill's and each step's logits within 2e-2 (the serving
strand's tolerance), `dense_len`, `total_len` and the five traffic
metrics exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache.manager import zero_metrics as j_zero
from repro.core.tiercache.policy import Policy as JPolicy
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache.manager import METRICS, zero_metrics
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.interop import model_params_from_jax
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import to_torch

PROMPT, STEPS, BATCH, LAYERS = 24, 32, 2, 2
TOL = 2e-2


@pytest.mark.parametrize("arch", ["yi-6b", "minitron-4b", "yi-34b"])
def test_dense_arch_served_as_the_reference(arch):
    jcfg = J_ARCHS[arch].reduced(num_layers=LAYERS)
    tcfg = T_ARCHS[arch].reduced(num_layers=LAYERS)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jb = j_build(jcfg)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tokens = np.asarray(j_batch(jcfg, BATCH, PROMPT)["tokens"])

    # the reference: prefill, then STEPS jitted greedy serve steps
    policy = JPolicy.IPS_AGC
    jspec = j_tier_spec(jb, PROMPT + STEPS, policy, hot_window=16,
                        page_tokens=8, group=16)
    jcache, jlogits = jax.jit(lambda p, b: jb.prefill(p, b, jspec))(
        jparams, {"tokens": jnp.asarray(tokens)})
    jstep = jax.jit(j_serve_step(jb, jspec, policy))
    jm = j_zero()
    token = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    inputs, want = [], []
    for _ in range(STEPS):
        inputs.append(np.asarray(token))
        token, lg, jcache, jm = jstep(jparams, jcache, token, jm)
        want.append(np.asarray(lg))

    # the port, teacher-forced on the reference's tokens
    tpol = TPolicy(int(policy))
    tb = t_build(tcfg, device="cpu")
    assert tb.cache_kind == "gqa"
    spec = t_tier_spec(tb, PROMPT + STEPS, tpol, hot_window=16,
                       page_tokens=8, group=16)
    assert spec.s_dense == jspec.s_dense
    cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)}, spec)
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL, err_msg=f"{arch} prefill")
    step = t_serve_step(tb, spec, tpol)
    metrics = zero_metrics()
    for i, (tok, w) in enumerate(zip(inputs, want)):
        _, lg, cache, metrics = step(tparams, cache, to_torch(tok), metrics)
        np.testing.assert_allclose(lg.float().numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=f"{arch} step {i}")
    assert cache["dense_len"] == int(jcache["dense_len"])
    assert cache["total_len"] == int(jcache["total_len"]) == PROMPT + STEPS
    for k in METRICS:
        assert (np.float32(metrics[k]).view(np.uint32)
                == np.float32(jm[k]).view(np.uint32)), (arch, k)
    assert float(metrics["repack_tokens"]) > 0
