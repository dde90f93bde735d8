"""The port's text surface and its chunked-prefill extend step against the
JAX package's.

- Text: the port's ServingServer and the JAX one, on the same llama-tiny
  weights, with the same WordLevel tokenizer built here from a vocabulary
  (nothing is downloaded): a ``{"text": ...}`` body encodes to the same
  tokens, and the reply's ``text`` and the stream's last event's are the
  JAX server's and ``tokenizer.decode(tokens)``; the three 400s carry the
  JAX server's words; ``KFTPU_SERVING_TOKENIZER`` loads a file or a
  directory holding ``tokenizer.json``.
- The extend step, in the form the card captures (start, true_len, slot
  and write_from device tensors, the slot's row taken by a device index):
  greedy tokens equal to the JAX engine's for a long prompt on slot 1
  while slot 0 decodes (f32 weights, projections x8 as in
  tests/test_torch_serving.py; the activation-dtype and int8 KV caches),
  and on the paged pool for a sharer whose shared head puts write_from
  past its first chunk, with a slide-back final chunk. Greedy tokens are
  compared exactly; a restricted sampled long prompt is checked for its
  count.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn
from tokenizers import Tokenizer, pre_tokenizers
from tokenizers import models as tok_models

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.serving import ServingConfig as JaxServingConfig
from kubeflow_tpu.serving import ServingEngine as JaxServingEngine
from kubeflow_tpu.serving.server import ServingServer as JaxServingServer
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serving import (
    ServingConfig,
    ServingEngine,
    ServingServer,
)
from kubeflow_tpu_torch.serving.server import build_server, env_config
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

MAX_LEN, BUCKETS, BS = 64, (8, 16), 8
# A 40-token prompt takes chunks at 0 and 16 and a final chunk slid back
# from 32 to 24.
LONG = [(5 * i + 2) % 250 for i in range(40)]


@pytest.fixture(scope="module")
def shared():
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, max_seq_len=MAX_LEN)
    jmodel = JaxLlama(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    params = jax.tree.map(lambda x: x * 8 if x.ndim >= 2 else x, params)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=MAX_LEN)
    return jmodel, params, tcfg, llama_params_from_jax(params, tcfg)


def _paged_kw(paged):
    blocks = 2 * MAX_LEN // BS
    return (({"paged_kv_blocks": blocks, "paged_kv_block_size": BS},
             {"kv_blocks": blocks, "kv_block_size": BS}) if paged
            else ({}, {}))


def engines(shared, model_kw=None, paged=False):
    """(port engine, JAX engine) of one configuration on the same
    weights: 2 slots, max_len 64, buckets 8 and 16."""
    jmodel, params, tcfg, sd = shared
    mkw, skw = _paged_kw(paged)
    mkw = {**(model_kw or {}), **mkw}
    kw = dict(param_dtype="", max_batch=2, max_len=MAX_LEN,
              prefill_buckets=BUCKETS, **skw)
    model = Llama(dataclasses.replace(tcfg, **mkw))
    model.load_state_dict(sd)
    port = ServingEngine(model, ServingConfig(**kw), device="cpu",
                         registry=MetricsRegistry())
    jeng = JaxServingEngine(JaxLlama(dataclasses.replace(jmodel.cfg, **mkw)),
                            params, JaxServingConfig(**kw),
                            registry=JaxRegistry())
    return port, jeng


def drive(eng, first, second, steps_between=2):
    """``first`` admitted and decoding for ``steps_between`` steps, then
    ``second`` admitted beside it (the next free slot, 1); both to the
    end, step by step. Returns both token lists."""
    a = eng.submit(first[0], max_new_tokens=first[1])
    for _ in range(steps_between):
        eng.step()
    b = eng.submit(second[0], max_new_tokens=second[1])
    while eng.queued or eng.active_slots:
        eng.step()
    return eng.result(a).tokens, eng.result(b).tokens


def watch_extends(eng):
    """Records each extend dispatch's (start, true_len, slot, write_from)
    as the step receives them: device tensors."""
    seen = []
    step = eng._extend_step

    def noting(tok, start, true_len, slot, samp, variant, write_from=None):
        assert all(isinstance(t, torch.Tensor) for t in
                   (start, true_len, slot))
        seen.append((int(start), int(true_len), int(slot),
                     None if write_from is None else int(write_from)))
        return step(tok, start, true_len, slot, samp, variant, write_from)

    eng._extend_step = noting
    return seen


# ------------------------------------------------------------ the extend

@pytest.mark.parametrize("cache", ["activation", "int8"])
def test_extend_on_slot_1_while_slot_0_decodes_matches_jax(shared, cache):
    model_kw = {"kv_cache_dtype": "int8"} if cache == "int8" else {}
    port, jeng = engines(shared, model_kw)
    seen = watch_extends(port)
    with torch.no_grad():
        got = drive(port, ([9, 4, 7], 14), (LONG, 6))
    assert got == drive(jeng, ([9, 4, 7], 14), (LONG, 6))
    assert [s[:3] for s in seen] == [(0, 16, 1), (16, 16, 1), (24, 16, 1)]
    assert port.extend_dispatches == 3


def test_paged_sharer_extend_writes_from_its_shared_head(shared):
    """The sharer's prompt opens with the live holder's three whole pages
    (24 tokens): its chunks start at 0, 16 and 24 (slid back), with
    write_from 24, so its first chunk writes only the scratch page."""
    head = [(3 * i + 1) % 250 for i in range(24)]
    holder, sharer = (head + [7, 8, 9], 20), (head + LONG[:16], 6)
    port, jeng = engines(shared, paged=True)
    seen = watch_extends(port)
    with torch.no_grad():
        got = drive(port, holder, sharer, steps_between=1)
    assert got == drive(jeng, holder, sharer, steps_between=1)
    sharer_chunks = [s for s in seen if s[2] == 1]
    assert sharer_chunks == [(0, 16, 1, 24), (16, 16, 1, 24),
                             (24, 16, 1, 24)]
    assert port.blocks.shared_refs_total >= 3
    dense, _ = engines(shared)
    with torch.no_grad():
        assert got == drive(dense, holder, sharer, steps_between=1)
    port.blocks.check_conservation()
    assert port.blocks.blocks_live == 0


def test_restricted_sampled_long_prompt_serves(shared):
    port, _ = engines(shared)
    with torch.no_grad():
        rid = port.submit(LONG, max_new_tokens=5, temperature=0.8, top_k=5,
                          top_p=0.9)
        port.run()
    toks = port.result(rid).tokens
    assert len(toks) == 5 and all(0 <= t < 256 for t in toks)
    assert port.extend_dispatches == 3


# ------------------------------------------------------------ the text

def _tokenizer(path=None):
    """WordLevel over the whole tiny vocabulary (id i is "w<i>", 0 the
    unknown word), split on whitespace."""
    vocab = {"<unk>": 0, **{f"w{i}": i for i in range(1, 256)}}
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    if path is not None:
        tok.save(str(path))
    return tok


@pytest.fixture(scope="module")
def servers(shared):
    port, jeng = engines(shared)
    tok = _tokenizer()
    pair = (ServingServer(port, tokenizer=tok).start(),
            JaxServingServer(jeng, tokenizer=tok).start())
    yield pair
    for server in pair:
        server.stop()


def _post(server, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if body.get("stream"):
            return [json.loads(line) for line in r]
        return json.load(r)


# Past the largest bucket: the text's tokens go through the extend.
TEXT = " ".join(f"w{t}" for t in LONG[:20])


@pytest.mark.parametrize("stream", [False, True])
def test_text_reply_matches_the_jax_server(servers, stream):
    port, jax_server = servers
    body = {"text": TEXT, "max_new_tokens": 6, "stream": stream}
    got, want = _post(port, body), _post(jax_server, body)
    if stream:
        assert all("text" not in c for c in got[:-1])
        got_toks = [t for c in got[:-1] for t in c["tokens"]]
        want_toks = [t for c in want[:-1] for t in c["tokens"]]
        got, want = dict(got[-1], tokens=got_toks), \
            dict(want[-1], tokens=want_toks)
    assert got["prompt_len"] == want["prompt_len"] == 20
    assert got["tokens"] == want["tokens"]
    assert got["text"] == want["text"] == port.tokenizer.decode(
        got["tokens"])
    assert got["text"].split() == [f"w{t}" if t else "<unk>"
                                   for t in got["tokens"]]


TEXT_400S = {
    "no_tokenizer": ("w1", "body.text requires a server-side tokenizer "
                           "(KFTPU_SERVING_TOKENIZER)"),
    "not_a_string": (5, "body.text must be a string"),
    "empty": ("   ", "body.text tokenised to nothing"),
}


@pytest.mark.parametrize("case", sorted(TEXT_400S))
def test_text_errors_are_the_jax_servers_400s(servers, case):
    text, message = TEXT_400S[case]
    body = {"text": text}
    replies = []
    for server in servers:
        tok = server.tokenizer
        if case == "no_tokenizer":
            server.tokenizer = None
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(server, body)
        finally:
            server.tokenizer = tok
        assert exc.value.code == 400
        replies.append(json.load(exc.value))
    assert replies[0] == replies[1] == {"error": message}


@pytest.mark.parametrize("form", ["file", "directory"])
def test_tokenizer_env_loads_a_file_or_a_directory(monkeypatch, tmp_path,
                                                   form):
    _tokenizer(tmp_path / "tokenizer.json")
    for key, value in {
            "KFTPU_PLATFORM": "cpu", "KFTPU_SERVING_MODEL": "llama-tiny",
            "KFTPU_SERVING_MAX_LEN": "64", "KFTPU_SERVING_HOST": "127.0.0.1",
            "KFTPU_SERVING_PORT": "0",
            "KFTPU_SERVING_TOKENIZER": str(
                tmp_path / "tokenizer.json" if form == "file"
                else tmp_path)}.items():
        monkeypatch.setenv(key, value)
    server = build_server(env_config())
    assert server.tokenizer.encode("w3 w250 zzz").ids == [3, 250, 0]
    assert server.engine.cfg.max_len == 64


def test_tokenizers_is_imported_only_in_build_server():
    """The chip machine may lack the ``tokenizers`` package: the port
    imports it in ``serving/server.py::build_server`` only, where a
    tokenizer is asked for."""
    import ast
    import os

    pkg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "kubeflow_tpu_torch")
    sites = []
    for root, _, files in os.walk(pkg):
        for name in (f for f in files if f.endswith(".py")):
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            parent = {child: node for node in ast.walk(tree)
                      for child in ast.iter_child_nodes(node)}
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module or ""]
                        if isinstance(node, ast.ImportFrom) else [])
                if not any(m.split(".")[0] == "tokenizers" for m in mods):
                    continue
                fn = parent.get(node)
                while fn is not None and not isinstance(fn, ast.FunctionDef):
                    fn = parent.get(fn)
                sites.append((os.path.relpath(path, pkg),
                              fn.name if fn else None))
    assert sites == [(os.path.join("serving", "server.py"), "build_server")]
