"""The port's text towers, tokenizers and their importers against the JAX package's.

* CLIP-class ``TextEncoder`` (causal, learned affines, quick_gelu; and the
  byte-level default: affine-free, gelu_tanh) and ``T5Encoder`` (gated-gelu
  and relu) on the same random numpy trees: features and the EOS pooling
  rtol 1e-4, float32.
* ``CLIPBPETokenizer`` and ``UnigramTokenizer`` on synthetic vocabularies
  (vocabularies are checkpoint assets, the algorithm is under test): ids
  EQUAL to the JAX package's, which splits with the third-party ``regex``
  package where the port reads ``unicodedata``, on text that mixes Latin,
  accents (precomposed and combining), CJK, digits, ``²``, ``½``,
  punctuation, contractions, special tokens and whitespace runs.
* ``clip_text_encoder`` and ``t5_encoder`` on synthetic transformers-keyed
  state dicts of numpy arrays: trees EQUAL to the JAX importers', and a
  leftover key raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu.models import import_weights as jimport
from skrample_tpu.models import t5_encoder as jt5
from skrample_tpu.models import text_encoder as jtext
from skrample_tpu.models import tokenizers as jtok
from skrample_tpu_torch.models import import_weights as timport
from skrample_tpu_torch.models import t5_encoder as tt5
from skrample_tpu_torch.models import text_encoder as ttext
from skrample_tpu_torch.models import tokenizers as ttok

CLIP = {"vocab_size": 300, "dim": 64, "depth": 3, "heads": 4, "max_tokens": 16}
CLIP_CASES = {
    "clip": {"ln_affine": True, "act": "quick_gelu", "eos_id": 299, "ln_eps": 1e-5},
    "bytes": {"vocab_size": 259, "causal": False},
}
T5 = {"vocab_size": 120, "dim": 64, "head_dim": 16, "heads": 4, "ff_dim": 96, "depth": 2, "rel_buckets": 8, "rel_max_distance": 20}


def _close(got: torch.Tensor, want, rtol: float = 1e-4) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _clip_ids(case: str, seed: int) -> np.ndarray:
    "(3, 16) ids with an EOS somewhere in each row (none in the last row: pooling then reads position 0)."
    c = ttext.TextEncoderConfig(**{**CLIP, **CLIP_CASES[case]})
    ids = np.random.default_rng(seed).integers(0, c.resolved_eos_id, (3, 16)).astype(np.int32)
    ids[0, 9] = ids[1, 15] = ids[0, 12] = c.resolved_eos_id
    return ids


@pytest.mark.parametrize("case", list(CLIP_CASES))
def test_text_encoder_matches_jax(case: str) -> None:
    "Final features, penultimate features beside the full tower's pooling (``encode(layer_skip=1)``): rtol 1e-4."
    kw = {**CLIP, **CLIP_CASES[case]}
    config = ttext.TextEncoderConfig(**kw, compute_dtype=torch.float32)
    tree = ttext.random_param_tree(config, 0)
    port = ttext.TextEncoder(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jtext.TextEncoder(jtext.TextEncoderConfig(**kw, compute_dtype=jnp.float32))
    jtree = jax.tree.map(jnp.asarray, tree)
    ids = _clip_ids(case, 1)
    _close(port(ids), jax.jit(ref.apply)(jtree, jnp.asarray(ids)))
    feats, pooled = port.encode(torch.from_numpy(ids), layer_skip=1)
    want_feats, want_pooled = jax.jit(ref.encode, static_argnames="layer_skip")(jtree, jnp.asarray(ids), layer_skip=1)
    _close(feats, want_feats)
    _close(pooled, want_pooled)
    assert feats.dtype == pooled.dtype == torch.float32
    np.testing.assert_array_equal(port.param_tree()["blocks"][1]["qkv"]["w"], tree["blocks"][1]["qkv"]["w"])
    with pytest.raises(ValueError, match="max_tokens"):
        port(np.zeros((1, 17), np.int32))


@pytest.mark.parametrize("gated", [True, False])
def test_t5_encoder_matches_jax(gated: bool) -> None:
    "Bidirectional features with the bucketed relative bias (24 tokens reach the log buckets): rtol 1e-4."
    config = tt5.T5EncoderConfig(**T5, gated=gated, compute_dtype=torch.float32)
    tree = tt5.random_param_tree(config, 2)
    port = tt5.T5Encoder(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jt5.T5Encoder(jt5.T5EncoderConfig(**T5, gated=gated, compute_dtype=jnp.float32))
    ids = np.random.default_rng(3).integers(0, T5["vocab_size"], (2, 24)).astype(np.int32)
    _close(port(ids), jax.jit(ref.apply)(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids)))
    pos = np.arange(40)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(
        tt5._relative_position_bucket(rel, 32, 128), jt5._relative_position_bucket(rel, 32, 128)
    )


def test_fresh_towers_build_on_the_jax_init() -> None:
    "A fresh tower's tree has the JAX init's structure and shapes, in bf16 where asked (affines stay f32)."
    for port, ref in (
        (ttext.TextEncoder(ttext.TextEncoderConfig(**CLIP, **CLIP_CASES["clip"]), device="cpu", dtype=torch.bfloat16),
         jtext.TextEncoder(jtext.TextEncoderConfig(**CLIP, **CLIP_CASES["clip"]))),
        (tt5.T5Encoder(tt5.T5EncoderConfig(**T5), device="cpu", dtype=torch.bfloat16), jt5.T5Encoder(jt5.T5EncoderConfig(**T5))),
    ):
        want = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
        got = port.param_tree()
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(want)]
    assert port.blocks[0].q.weight.dtype == torch.bfloat16 and port.final_ln.dtype == torch.float32


# ---- tokenizers ----------------------------------------------------------------------------------------------

MERGES = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("c", "a"), ("ca", "t</w>"), ("h", "a"),
          ("ha", "t</w>"), ("i", "n</w>"), ("'", "t</w>"), ("1", "2"), ("é", "t")]
TEXTS = [
    "The cat AND the   hat!",
    "a cat in the hat, again... 42 cats?",
    "Isn't it the Café's crème brûlée? (déjà vu)",
    "東京タワー 和 猫 x² + ½y = 3⁴ ① ⅷ",
    "café naïve eͅ ſtraße 'ſ 'T 'RE",
    "<|startoftext|>cat<|endoftext|> \t\n tabs　and spaces ",
    "emoji 🐈‍⬛ mixed-UP_case #42 @home 12.5%",
    "",
    "cat " * 30,
]


def _clip_vocab() -> dict[str, int]:
    bu = jtok._bytes_to_unicode()
    vocab: dict[str, int] = {}
    for b in range(256):
        vocab.setdefault(bu[b], len(vocab))
        vocab.setdefault(bu[b] + "</w>", len(vocab))
    for a, b in MERGES:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab


def test_clip_bpe_ids_equal_jax() -> None:
    vocab = _clip_vocab()
    port, ref = ttok.CLIPBPETokenizer(vocab, MERGES), jtok.CLIPBPETokenizer(vocab, MERGES)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text), text
        assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))
    np.testing.assert_array_equal(port(TEXTS, length=24), ref(TEXTS, length=24))
    np.testing.assert_array_equal(port(TEXTS, length=77, pad_id=0), ref(TEXTS, length=77, pad_id=0))
    assert ttok._split("x² ½ ab12") == ["x", "²", "½", "ab", "1", "2"]  # ² and ½ are numbers, not letters
    with pytest.raises(ValueError, match="missing"):
        ttok.CLIPBPETokenizer({"a": 0}, [])


def _unigram_vocab() -> list[tuple[str, float]]:
    pieces = ["<pad>", "</s>", "<unk>", "▁", "▁the", "▁cat", "▁ca", "t", "h", "e", "▁a", "n", "d", "▁and", "at",
              "▁h", "a", "s", "é", "▁caf", "x", "²", "2", "▁1", "0", "東", "京", "▁東京", ",", ".", "!", "?"]
    rng = np.random.default_rng(4)
    return [(p, 0.0 if i < 3 else float(-rng.uniform(1, 12))) for i, p in enumerate(pieces)]


def test_unigram_ids_equal_jax(tmp_path) -> None:
    vocab = _unigram_vocab()
    specials = {"<extra_id_0>": 40, "<extra_id_1>": 41}
    port, ref = ttok.UnigramTokenizer(vocab, specials=specials), jtok.UnigramTokenizer(vocab, specials=specials)
    texts = [*TEXTS, "the cat<extra_id_0>and<extra_id_1> hat", "<extra_id_0>", "ｆｕｌｌ ｗｉｄｔｈ ² x 10!"]
    for text in texts:
        assert port.encode(text) == ref.encode(text), text
        assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))
    np.testing.assert_array_equal(port(texts, length=20), ref(texts, length=20))
    blob = {
        "model": {"type": "Unigram", "unk_id": 2, "vocab": [list(v) for v in vocab]},
        "added_tokens": [{"content": "<extra_id_0>", "id": 40}, {"content": "</s>", "id": 1}],
    }
    path = tmp_path / "tokenizer.json"
    path.write_text(__import__("json").dumps(blob))
    port, ref = ttok.UnigramTokenizer.from_tokenizer_json(path), jtok.UnigramTokenizer.from_tokenizer_json(path)
    assert (port.specials, port.eos_id, port.pad_id, port.unk_id) == (ref.specials, ref.eos_id, ref.pad_id, ref.unk_id)
    np.testing.assert_array_equal(port(texts, length=20), ref(texts, length=20))


def test_byte_tokenizer_equals_jax() -> None:
    port, ref = ttext.ByteTokenizer(), jtext.ByteTokenizer()
    np.testing.assert_array_equal(port.batch(TEXTS, 40), ref.batch(TEXTS, 40))
    assert port.decode(port.encode(TEXTS[3], 64)) == ref.decode(ref.encode(TEXTS[3], 64))


# ---- importers -----------------------------------------------------------------------------------------------

CLIP_HF = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 256, "num_hidden_layers": 2,
           "num_attention_heads": 4, "max_position_embeddings": 16, "hidden_act": "quick_gelu",
           "layer_norm_eps": 1e-5, "eos_token_id": 299, "projection_dim": 48}
T5_HF = {"vocab_size": 120, "d_model": 64, "d_kv": 16, "num_heads": 4, "d_ff": 96, "num_layers": 2,
         "feed_forward_proj": "gated-gelu", "relative_attention_num_buckets": 8,
         "relative_attention_max_distance": 20, "layer_norm_epsilon": 1e-6}


def clip_state_dict(hf: dict, seed: int, projection: bool = True) -> dict[str, np.ndarray]:
    "Random arrays under transformers' CLIPTextModel(WithProjection) names."
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}
    D, I = hf["hidden_size"], hf["intermediate_size"]

    def put(name: str, *shape: int, bias: bool = True) -> None:
        sd[f"{name}.weight"] = rng.standard_normal(shape).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)

    pre = "text_model"
    put(f"{pre}.embeddings.token_embedding", hf["vocab_size"], D, bias=False)
    put(f"{pre}.embeddings.position_embedding", hf["max_position_embeddings"], D, bias=False)
    for i in range(hf["num_hidden_layers"]):
        layer = f"{pre}.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{layer}.self_attn.{name}", D, D)
        put(f"{layer}.mlp.fc1", I, D)
        put(f"{layer}.mlp.fc2", D, I)
        put(f"{layer}.layer_norm1", D)
        put(f"{layer}.layer_norm2", D)
    put(f"{pre}.final_layer_norm", D)
    if projection:
        put("text_projection", hf["projection_dim"], D, bias=False)
    return sd


def t5_state_dict(hf: dict, seed: int) -> dict[str, np.ndarray]:
    "Random arrays under transformers' T5EncoderModel names (with the tied ``encoder.embed_tokens``)."
    rng = np.random.default_rng(seed)
    D, inner, F = hf["d_model"], hf["num_heads"] * hf["d_kv"], hf["d_ff"]

    def r(*shape: int) -> np.ndarray:
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"shared.weight": r(hf["vocab_size"], D), "encoder.final_layer_norm.weight": r(D)}
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = r(hf["relative_attention_num_buckets"], hf["num_heads"])
    for i in range(hf["num_layers"]):
        attn, ff = f"encoder.block.{i}.layer.0", f"encoder.block.{i}.layer.1"
        for name in ("q", "k", "v"):
            sd[f"{attn}.SelfAttention.{name}.weight"] = r(inner, D)
        sd[f"{attn}.SelfAttention.o.weight"] = r(D, inner)
        sd[f"{attn}.layer_norm.weight"] = r(D)
        sd[f"{ff}.layer_norm.weight"] = r(D)
        for name in ("wi_0", "wi_1") if hf["feed_forward_proj"] == "gated-gelu" else ("wi",):
            sd[f"{ff}.DenseReluDense.{name}.weight"] = r(F, D)
        sd[f"{ff}.DenseReluDense.wo.weight"] = r(D, F)
    return sd


def _assert_trees_equal(got, want) -> None:
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _fields(config, drop: tuple[str, ...] = ()) -> dict:
    return {k: v for k, v in dataclasses.asdict(config).items() if k not in ("compute_dtype", *drop)}


@pytest.mark.parametrize("projection", [True, False])
def test_clip_importer_equals_jax(projection: bool) -> None:
    sd = clip_state_dict(CLIP_HF, 5, projection)
    config, tree = timport.clip_text_encoder((sd, SimpleNamespace(**CLIP_HF)))
    jmodel, jtree = jimport.clip_text_encoder((sd, SimpleNamespace(**CLIP_HF)))
    _assert_trees_equal(tree, jtree)
    assert _fields(config, ("proj_dim",)) == _fields(jmodel.config)
    assert config == dataclasses.replace(timport.clip_text_config(CLIP_HF), proj_dim=48 if projection else 64)
    port = ttext.TextEncoder(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ids = np.array([[298, 5, 7, 299, 1, 2]], np.int32)
    _close(port.encode(ids)[1], jax.jit(jmodel.encode)(jtree, jnp.asarray(ids))[1])
    sd["text_model.embeddings.position_ids"] = np.arange(16)[None]  # a buffer some versions save: read and dropped
    timport.clip_text_encoder((sd, CLIP_HF))
    sd["text_model.encoder.layers.9.mlp.fc1.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        timport.clip_text_encoder((sd, CLIP_HF))


@pytest.mark.parametrize("proj", ["gated-gelu", "relu"])
def test_t5_importer_equals_jax(proj: str) -> None:
    hf = {**T5_HF, "feed_forward_proj": proj}
    sd = t5_state_dict(hf, 6)
    config, tree = timport.t5_encoder((sd, SimpleNamespace(**hf)))
    jmodel, jtree = jimport.t5_encoder((sd, SimpleNamespace(**hf)))
    _assert_trees_equal(tree, jtree)
    assert _fields(config) == _fields(jmodel.config)
    tt5.T5Encoder(config, device="cpu").load_jax_params(tree)
    tied = dict(sd, **{"encoder.embed_tokens.weight": sd["shared.weight"] + 1})
    with pytest.raises(ValueError, match="tied"):
        timport.t5_encoder((tied, hf))
    sd["encoder.block.0.layer.1.extra.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        timport.t5_encoder((sd, hf))
