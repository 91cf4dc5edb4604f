"""The port's CLIP tokenizer and safetensors IO.

Tokenizer: the port's `data/tokenizer.py` and JAX's give identical ids on
the same vocab and merges, from a tiny vocab to an SD2-style directory
("!" padding in both `pad_token` forms, and EOS padding without
`tokenizer_config.json`), on the reference's prompt grid, awkward text and
a hypothesis sweep of printable strings. Safetensors: `bridge.safetensors_io`
reads what the `safetensors` package writes and the other way round, bit
for bit, for every dtype the format names here.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from safetensors.numpy import load_file as st_load_np
from safetensors.numpy import save_file as st_save_np
from safetensors.torch import load_file as st_load_pt
from safetensors.torch import save_file as st_save_pt

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

sys.path.pop(0)

from faceposegenerator_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from faceposegenerator_tpu.pipelines.sweep import DEFAULT_NEGATIVE, build_prompt_combinations, build_prompts  # noqa: E402
from faceposegenerator_tpu_torch.bridge import safetensors_io as sio  # noqa: E402
from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402

AWKWARD = [
    "", "   ", "AB  ab\t\nab", "face &amp; portrait &lt;b&gt; photo", "&amp;amp;", "i'm sure they'll say it's ok",
    "they've we'd you're", "123 4567 8", "ünïcödé façade — naïve", "日本語 テキスト", "emoji 🙂 face",
    "side-portrait,  forest background!!", "a.b,c;d:e", "x" * 300, "<|startoftext|> inner <|endoftext|>",
]


# a byte-level vocab in CLIP's layout ("!" 0, bos 49406, eos 49407) with
# merges that make each given word one token: chip_smoke.py's, which phase 12
# writes into its synthetic SD2.1 directory
sd2_vocab = chip_smoke.synthetic_vocab


def write_tokenizer_dir(path, vocab, merges, pad_token="!"):
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    if pad_token is not None:
        (path / "tokenizer_config.json").write_text(json.dumps({"pad_token": pad_token, "model_max_length": 77}))
    return path


def grid_prompts():
    combos = build_prompt_combinations(add_age=True)
    gender = {"id0": "woman", "id1": "man"}
    return (build_prompts("id0", gender, combos, num_prompts=21, seed=0)
            + build_prompts("id1", gender, combos, num_prompts=21, seed=1) + [DEFAULT_NEGATIVE])


def grid_words():
    return sorted({w for p in grid_prompts() for w in p.replace(",", " ").replace("-", " ").split()})


def tiny():
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, c in enumerate("abcdefghijklmnopqrstuvwxyz"):
        vocab[c] = 2 + 2 * i
        vocab[c + "</w>"] = 3 + 2 * i
    vocab["ab</w>"] = 100
    vocab["ph"] = 101
    merges = [("a", "b</w>"), ("p", "h")]
    return vocab, merges


def both(vocab, merges, **kw):
    return CLIPTokenizer(vocab, merges, **kw), JTokenizer(vocab, merges, **kw)


def test_tiny_vocab_with_merges():
    port, ref = both(*tiny(), model_max_length=16)
    for texts in (["ab"], ["ba", "AB", "  a   b "], ["c " * 40], ["phab ph"]):
        ids = port(texts)
        assert ids.dtype == np.int32 and ids.shape == (len(texts), 16)
        np.testing.assert_array_equal(ids, ref(texts))
    assert port("ab")[0, 1] == 100 and port("c " * 40)[0, -1] == 1


@pytest.mark.parametrize("pad", ["!", {"content": "!", "lstrip": False}, None],
                         ids=["string", "added-token", "no-config"])
def test_sd2_directory_pads_as_jax(tmp_path, pad):
    vocab, merges = sd2_vocab(grid_words())
    d = write_tokenizer_dir(tmp_path / "tokenizer", vocab, merges, pad_token=pad)
    port, ref = CLIPTokenizer.from_pretrained(str(d)), JTokenizer.from_pretrained(str(d))
    assert port.pad_token_id == ref.pad_token_id == (0 if pad else 49407)
    prompts = grid_prompts()
    ids = port(prompts)
    np.testing.assert_array_equal(ids, ref(prompts))
    np.testing.assert_array_equal(port(""), ref(""))
    if pad:  # SD2's "!" padding: the empty prompt is bos, eos, then zeros
        assert list(port("")[0, :3]) == [49406, 49407, 0] and port("")[0, 2:].max() == 0
    # every grid word is one token
    for w in grid_words():
        assert len(port.encode(w)) == 1, w


def test_prompt_grid_decodes_back(tmp_path):
    vocab, merges = sd2_vocab(grid_words())
    d = write_tokenizer_dir(tmp_path / "tokenizer", vocab, merges)
    port, ref = CLIPTokenizer.from_pretrained(str(d)), JTokenizer.from_pretrained(str(d))
    for p in grid_prompts()[:6]:
        ids = port(p)[0]
        ids = ids[ids != port.pad_token_id]
        assert port.decode(ids) == ref.decode(ids)
        assert port.decode(ids).replace(" ", "") == p.lower().replace(" ", "")


@pytest.mark.parametrize("text", AWKWARD)
def test_awkward_text_and_truncation(text):
    port, ref = both(*sd2_vocab(["face", "portrait"]), pad_token="!")
    np.testing.assert_array_equal(port(text), ref(text))
    ids = port(text)[0]
    assert ids[0] == 49406 and (ids == 49407).sum() >= 1
    assert port.decode(ids) == ref.decode(ids)


def test_batches_and_short_max_length():
    port, ref = both(*sd2_vocab(["face"]), model_max_length=8, pad_token="!")
    texts = AWKWARD[:8]
    np.testing.assert_array_equal(port(texts), ref(texts))
    assert port(texts).shape == (8, 8) and (port(texts)[:, -1] != 0).sum() >= 1  # truncated rows end in eos


@settings(max_examples=60, deadline=None)
@given(st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=0x2FF), max_size=60))
def test_printable_strings_sweep(text):
    port, ref = _SWEEP
    np.testing.assert_array_equal(port(text), ref(text))


_SWEEP = both(*sd2_vocab(["face", "photo", "the"]), pad_token="!")


# --- safetensors -----------------------------------------------------------

DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.int16, torch.int8, torch.uint8, torch.bool]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), ()][i % 4]
        x = torch.randn(shape, generator=g) * 50
        out[f"t.{i}.{str(dt).split('.')[-1]}"] = x > 0 if dt == torch.bool else x.to(dt)
    out["empty"] = torch.zeros(0, 4)
    return out


def _same(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.dim() and a.dtype != torch.bool else a,
                       b.view(torch.uint8) if b.dim() and b.dtype != torch.bool else b)


def test_reads_what_safetensors_writes(tmp_path):
    src = _tensors()
    st_save_pt(src, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = sio.load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(src)
    for k in src:
        _same(got[k], src[k])
    assert sio.read_header(str(tmp_path / "a.safetensors"))[0]["__metadata__"] == {"format": "pt"}
    # the numpy view: BF16 widened to fp32, exactly
    arrs = sio.load_numpy(str(tmp_path / "a.safetensors"))
    for k, v in src.items():
        want = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert arrs[k].dtype == want.dtype
        np.testing.assert_array_equal(arrs[k], want)


def test_safetensors_reads_what_the_port_writes(tmp_path):
    src = _tensors(1)
    sio.save_file(src, str(tmp_path / "b.safetensors"), metadata={"who": "port"})
    got = st_load_pt(str(tmp_path / "b.safetensors"))
    assert set(got) == set(src)
    for k in src:
        _same(got[k], src[k])
    # numpy arrays in, numpy arrays back through the package
    arrs = {k: v.numpy() for k, v in src.items() if v.dtype != torch.bfloat16}
    sio.save_file(arrs, str(tmp_path / "c.safetensors"))
    back = st_load_np(str(tmp_path / "c.safetensors"))
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    st_save_np(arrs, str(tmp_path / "d.safetensors"))
    for k, v in sio.load_numpy(str(tmp_path / "d.safetensors")).items():
        np.testing.assert_array_equal(v, arrs[k])


def test_truncated_or_malformed_files_raise(tmp_path):
    p = tmp_path / "ok.safetensors"
    sio.save_file(_tensors(2), str(p))
    raw = p.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    cases = {"short length": raw[:5], "truncated header": raw[: 8 + n // 2], "truncated data": raw[:-3],
             "bad json": raw[:8] + b"{" * n + raw[8 + n:], "extra data": raw + b"\0" * 4}
    for name, blob in cases.items():
        bad = tmp_path / f"{name.replace(' ', '_')}.safetensors"
        bad.write_bytes(blob)
        with pytest.raises(ValueError):
            sio.load_file(str(bad))
