"""llama-quantize in the PyTorch port (tools/quantize_tool.py) against the
JAX package's tool: the files it writes are byte-identical for q8_0, q4_0
and q5_k_m on an F32 file (and for q4_k_m under an importance matrix),
main() prints the same summary, --dry-run writes nothing, and both choose
the same type for every tensor at every file type. The port's fixtures at
the new file types hold each tensor at the type the tool would write."""

import re

import numpy as np
import pytest

from llama_cpp_tpu.gguf.constants import GGMLType as JaxType
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu.tools import quantize_tool as jax_tool
from llama_cpp_tpu_torch.gguf.constants import GGMLType
from llama_cpp_tpu_torch.gguf.reader import read_gguf
from llama_cpp_tpu_torch.testing import make_bench_qwen3_gguf
from llama_cpp_tpu_torch.tools import quantize_tool as tool

TINY = dict(vocab_size=512, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, seed=4)


@pytest.fixture(scope="module")
def f32_file(tmp_path_factory):
    return jax_make_tiny(str(tmp_path_factory.mktemp("qtool") / "f32.gguf"), ftype="f32",
                         **TINY)


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ftype", ["q8_0", "q4_0", "q5_k_m"])
def test_output_file_is_byte_identical_to_jax(f32_file, tmp_path, ftype):
    got, ref = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    stats = tool.quantize_model(f32_file, got, ftype)
    jstats = jax_tool.quantize_model(f32_file, ref, ftype)
    assert read(got) == read(ref)
    assert {k: stats[k] for k in ("n_tensors", "in_bytes", "out_bytes", "per_type")} == {
        k: jstats[k] for k in ("n_tensors", "in_bytes", "out_bytes", "per_type")}
    types = {name: info.dtype for name, info in read_gguf(got).tensors.items()}
    want = {"q8_0": GGMLType.Q8_0, "q4_0": GGMLType.Q4_0, "q5_k_m": GGMLType.Q5_K}[ftype]
    assert types["blk.0.ffn_up.weight"] == want
    assert types["blk.0.attn_norm.weight"] == GGMLType.F32
    if ftype == "q5_k_m":
        assert types["blk.0.attn_v.weight"] == GGMLType.Q6_K


def test_imatrix_output_is_byte_identical_to_jax(f32_file, tmp_path):
    """q4_k_m under an importance matrix (per-column weights of two
    tensors, one of them attn_v, which q4_k_m stores as Q6_K)."""
    rng = np.random.default_rng(6)
    imatrix = {"blk.0.ffn_up.weight": rng.random(256).astype(np.float32) + 0.1,
               "blk.0.attn_v.weight": rng.random(256).astype(np.float32) + 0.1}
    np.savez(tmp_path / "imatrix.npz", **imatrix)
    got, ref = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    assert tool.main([f32_file, got, "q4_k_m", "--imatrix", str(tmp_path / "imatrix.npz")]) == 0
    jax_tool.quantize_model(f32_file, ref, "q4_k_m", imatrix=imatrix)
    plain = str(tmp_path / "plain.gguf")
    tool.quantize_model(f32_file, plain, "q4_k_m")
    assert read(got) == read(ref) != read(plain)


def test_main_prints_the_jax_tools_summary(f32_file, tmp_path, capsys):
    assert tool.main([f32_file, str(tmp_path / "port.gguf"), "q8_0"]) == 0
    got = capsys.readouterr().out
    jax_tool.main([f32_file, str(tmp_path / "jax.gguf"), "q8_0"])
    ref = capsys.readouterr().out

    def untimed(s):
        return re.sub(r"in [0-9.]+s;", "in Ts;", s)

    assert untimed(got) == untimed(ref)
    assert got.splitlines()[-1].startswith("done: 21 tensors")


def test_dry_run_writes_nothing(f32_file, tmp_path):
    dst = tmp_path / "none.gguf"
    stats = tool.quantize_model(f32_file, str(dst), "q5_0", dry_run=True)
    assert not dst.exists() and stats["per_type"]["Q5_0"] == 16
    assert stats["out_bytes"] < stats["in_bytes"]


NAMES = ("token_embd.weight", "output.weight", "blk.3.attn_v.weight", "blk.0.attn_q.weight",
         "blk.1.ffn_down.weight", "blk.0.attn_norm.weight", "blk.0.attn_q.bias")


@pytest.mark.parametrize("ftype", sorted(tool.FTYPES))
def test_target_types_match_jax(ftype):
    assert sorted(tool.FTYPES) == sorted(jax_tool.FTYPES)
    default, ftype_id = tool.FTYPES[ftype]
    jdefault, jftype_id = jax_tool.FTYPES[ftype]
    assert (int(default), int(ftype_id)) == (int(jdefault), int(jftype_id))
    for name in NAMES:
        for shape in ((512, 1024), (512, 320), (1024,)):
            got = tool.tensor_target_type(name, shape, default, ftype)
            ref = jax_tool.tensor_target_type(name, shape, JaxType(int(default)), ftype)
            assert int(got) == int(ref), (name, shape)


@pytest.mark.parametrize("ftype", ["q8_0", "q5_k_m", "q5_0", "q4_0", "f16"])
def test_fixture_types_follow_the_tools_rule(tmp_path, ftype):
    """make_bench_arch_gguf (through the Qwen3 wrapper) at a new file type
    writes each tensor at tensor_target_type's choice; F16 matrices hold
    seeded values, and the tool turns that file into the same types."""
    path = make_bench_qwen3_gguf(str(tmp_path / "m.gguf"), n_layers=1, n_embd=256, n_heads=2,
                                 n_kv_heads=1, head_dim=128, n_ff=512, vocab_size=512,
                                 ftype=ftype)
    default = tool.FTYPES[ftype][0]
    f = read_gguf(path)
    for name, info in f.tensors.items():
        assert info.dtype == tool.tensor_target_type(name, info.shape, default, ftype), name
    if ftype == "f16":
        out = str(tmp_path / "q8.gguf")
        tool.quantize_model(path, out, "q8_0")
        types = {info.dtype for info in read_gguf(out).tensors.values()}
        assert types == {GGMLType.Q8_0, GGMLType.F32}
