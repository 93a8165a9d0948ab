"""The Hopper build gate (alphafold2_tpu_torch/analysis/lowering.py) on the
CPU, where there is no nvcc: its cases stand for the JAX gate's one for
one; the ptxas report parser reads reports recorded on the card's machine;
sm_90's limits reject each synthetic bad plan; the negative control's
classifier accepts ptxas's shared-data refusal and nothing else; the CLI
exits 2 without nvcc; and X's plain version equals X's Pallas kernel
(interpret mode) bit for bit."""

import ctypes
import json
import os
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from alphafold2_tpu.analysis import lowering as jax_lowering
from alphafold2_tpu_torch.analysis import lowering
from alphafold2_tpu_torch.ops.cuda import axial, build, controls, tied_row

torch.set_num_threads(1)

# ptxas -v as nvcc printed it on the card's machine (build/torch_kernels/
# *.log): two instantiations of csrc/block_sparse_attention_bwd.cu, one
# spilling, X's valid kernel, and the report ptxas gave for the mis-tiled
# control before refusing it
BWD = "_ZN62_GLOBAL__N__11c3b89c_29_block_sparse_attention_bwd_cu_0c59534c"
DKV = BWD + "10dkv_kernelI13__nv_bfloat16Li64ELi128EEEvNS_3BwdEi"
DQ = BWD + "9dq_kernelI13__nv_bfloat16Li64ELi128EEEvNS_3BwdEi"
X = "_ZN46_GLOBAL__N__b117a957_13_scale_rows_cu_9c597b6210scale_rowsEPKfPfi"
MISTILED = ("_ZN55_GLOBAL__N__df0ac9e4_22_scale_rows_mistiled_cu_9536f1e3"
            "19scale_rows_mistiledEPKfPfi")
REPORT = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{DKV}' for 'sm_90a'
ptxas info    : Function properties for {DKV}
    40 bytes stack frame, 38 bytes spill stores, 80 bytes spill loads
ptxas info    : Used 255 registers, used 16 barriers, 40 bytes cumulative stack size
ptxas info    : Compile time = 636.614 ms
ptxas info    : Compiling entry function '{DQ}' for 'sm_90a'
ptxas info    : Function properties for {DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compile time = 533.699 ms
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{X}' for 'sm_90a'
ptxas info    : Function properties for {X}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 10 registers, used 0 barriers
ptxas info    : Compile time = 5.395 ms
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{MISTILED}' for 'sm_90a'
ptxas info    : Function properties for {MISTILED}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 1 barriers, 65536 bytes smem
ptxas info    : Compile time = 10.894 ms
"""
# demangled as cu++filt printed them on the card's machine (the other
# spelling of an anonymous namespace is in test_kernel_key)
DEMANGLED = {
    DKV: "void <unnamed>::dkv_kernel<__nv_bfloat16, (int)64, (int)128>(<unnamed>::Bwd, int)",
    DQ: "void <unnamed>::dq_kernel<__nv_bfloat16, (int)64, (int)128>(<unnamed>::Bwd, int)",
    X: "<unnamed>::scale_rows(const float *, float *, int)",
    MISTILED: "<unnamed>::scale_rows_mistiled(const float *, float *, int)",
}
REFUSAL = f"""\
ptxas error   : Entry function '{MISTILED}' uses too much shared data (0x10000 bytes, 0xc000 max)
"""


def _demangle(names):
    return {n: DEMANGLED[n] for n in names}


# K1's Hopper kernel and its combine pass at head dim 64, as ptxas reported
# them for csrc/fused_attention.cu on the card's machine (NVIDIA H100,
# nvcc for sm_90a)
SM90 = "_ZN3af24sm9021attention_kernel_sm90ILi64EEEv14CUtensorMap_stS2_S2_NS0_6ParamsE"
COMBINE = "_ZN3af24sm9014combine_kernelILi64EEEvNS0_13CombineParamsE"
K1_REPORT = f"""\
ptxas info    : Compiling entry function '{COMBINE}' for 'sm_90a'
ptxas info    : Function properties for {COMBINE}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
ptxas info    : Compiling entry function '{SM90}' for 'sm_90a'
ptxas info    : Function properties for {SM90}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 123 registers, used 16 barriers
"""
K1_DEMANGLED = {
    SM90: "void af2::sm90::attention_kernel_sm90<(int)64>(CUtensorMap_st, CUtensorMap_st, "
          "CUtensorMap_st, af2::sm90::Params)",
    COMBINE: "void af2::sm90::combine_kernel<(int)64>(af2::sm90::CombineParams)",
}

# K3's Hopper kernels and their merge pass at head dim 64, as ptxas reported
# them for csrc/fused_attention_bwd.cu on the card's machine (NVIDIA H100,
# nvcc for sm_90a)
K3_DQ = ("_ZN3af24sm904grad14dq_kernel_sm90ILi64EEEv14CUtensorMap_stS3_S3_S3_"
         "NS1_10GradParamsE")
K3_DKV = ("_ZN3af24sm904grad15dkv_kernel_sm90ILi64EEEv14CUtensorMap_stS3_S3_S3_"
          "NS1_10GradParamsE")
K3_MERGE = "_ZN3af24sm904grad17grad_merge_kernelILi64EEEvNS1_11MergeParamsE"
K3_REPORT = f"""\
ptxas info    : Compiling entry function '{K3_MERGE}' for 'sm_90a'
ptxas info    : Function properties for {K3_MERGE}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '{K3_DQ}' for 'sm_90a'
ptxas info    : Function properties for {K3_DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers
ptxas info    : Compiling entry function '{K3_DKV}' for 'sm_90a'
ptxas info    : Function properties for {K3_DKV}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""
_TMAPS = "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st"
K3_DEMANGLED = {
    K3_DQ: f"void af2::sm90::grad::dq_kernel_sm90<(int)64>({_TMAPS}, af2::sm90::grad::GradParams)",
    K3_DKV: f"void af2::sm90::grad::dkv_kernel_sm90<(int)64>({_TMAPS}, "
            "af2::sm90::grad::GradParams)",
    K3_MERGE: "void af2::sm90::grad::grad_merge_kernel<(int)64>(af2::sm90::grad::MergeParams)",
}

# K5's Hopper kernels at head dim 64 (K3's consumers on gathered stages), as
# ptxas reported them for csrc/block_sparse_attention_bwd.cu on the card's
# machine
K5_DQ = ("_ZN3af24sm904grad21sparse_dq_kernel_sm90ILi64EEEv14CUtensorMap_stS3_S3_S3_"
         "NS1_10GradParamsENS1_10ListParamsE")
K5_DKV = ("_ZN3af24sm904grad22sparse_dkv_kernel_sm90ILi64EEEv14CUtensorMap_stS3_S3_S3_"
          "NS1_10GradParamsENS1_10ListParamsE")
K5_REPORT = f"""\
ptxas info    : Compiling entry function '{K5_DKV}' for 'sm_90a'
ptxas info    : Function properties for {K5_DKV}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '{K5_DQ}' for 'sm_90a'
ptxas info    : Function properties for {K5_DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers
"""
_K5_ARGS = f"{_TMAPS}, af2::sm90::grad::GradParams, af2::sm90::grad::ListParams"
K5_DEMANGLED = {
    K5_DQ: f"void af2::sm90::grad::sparse_dq_kernel_sm90<(int)64>({_K5_ARGS})",
    K5_DKV: f"void af2::sm90::grad::sparse_dkv_kernel_sm90<(int)64>({_K5_ARGS})",
}

# K4's Hopper kernel at head dim 64 (K1's consumer pieces on K5a's gathered
# stages), as ptxas reported it for csrc/block_sparse_attention.cu on the
# card's machine
K4_FWD = ("_ZN3af24sm9022sparse_fwd_kernel_sm90ILi64EEEv14CUtensorMap_stS2_S2_"
          "NS0_6ParamsENS0_4grad10GradParamsENS4_10ListParamsE")
K4_REPORT = f"""\
ptxas info    : Compiling entry function '{K4_FWD}' for 'sm_90a'
ptxas info    : Function properties for {K4_FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 108 registers, used 2 barriers
"""
K4_DEMANGLED = {
    K4_FWD: "void af2::sm90::sparse_fwd_kernel_sm90<(int)64>(CUtensorMap_st, CUtensorMap_st, "
            "CUtensorMap_st, af2::sm90::Params, af2::sm90::grad::GradParams, "
            "af2::sm90::grad::ListParams)",
}


# K2's Hopper kernel at head dim 64, 128 and 64 output columns a block, as
# ptxas reported it for csrc/tied_row_attention.cu on the card's machine
K2_WIDE = ("_ZN3af24sm904tied30tied_row_attention_kernel_sm90ILi64ELi128EEEv14CUtensorMap_stS3_S3_"
           "NS1_10TiedParamsE")
K2_NARROW = ("_ZN3af24sm904tied30tied_row_attention_kernel_sm90ILi64ELi64EEEv14CUtensorMap_stS3_"
             "S3_NS1_10TiedParamsE")
K2_REPORT = "".join(f"""\
ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {registers} registers, used 1 barriers
""" for name, registers in ((K2_WIDE, 138), (K2_NARROW, 106)))
K2_DEMANGLED = {
    name: f"void af2::sm90::tied::tied_row_attention_kernel_sm90<(int)64, (int){c}>("
          "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, af2::sm90::tied::TiedParams)"
    for name, c in ((K2_WIDE, 128), (K2_NARROW, 64))
}


# ------------------------------------------------------------ cases


def test_cases_stand_for_the_jax_gate_one_for_one():
    jax_names = [name for name, _ in jax_lowering.CASES]
    ours = [c.name for c in lowering.CASES]
    assert [c.name for c in lowering.JAX_CASES] + [lowering.CONTROL_CASE] == jax_names
    assert ours[-1] == lowering.CONTROL_CASE and len(set(ours)) == len(ours)
    assert [c.name for c in lowering.PORT_CASES] == [
        "serve_pair_axial_384", "serve_msa_column", "serve_cross_pair_from_msa",
        "serve_cross_msa_from_pair", "serve_tied_rows", "train_pair_axial_128",
        "train_msa_column", "train_msa_row", "train_cross_pair_from_msa",
        "train_cross_msa_from_pair", "train_tied_rows", "sparse_train_pair_128",
        "sparse_pair_512", "edge_dense_d128", "edge_sparse_block128_d128",
        "edge_tied_rows_1280", "edge_tied_rows_wide_d32", "edge_tied_rows_wide_d128",
        "plm_tied_rows_8192", "plm_e2e_tied_rows_12288", "config4_tied_rows_1024",
        "edge_dense_d256", "pair_axial_d256", "template_axis", "config4_msa_column",
        "edge_packed_d32", "edge_packed_d128", "split_msa_rows_320", "split_plm_rows_8192",
        "bench_pair_axial_256", "scale_rows_4x512"]


def test_case_shapes_and_sources():
    by = {c.name: c for c in lowering.CASES}
    # JAX's block-sparse cases: block 128, 4 heads, head dim 64
    assert by["block_sparse_fwd_n1024"].launches[0].args == (None, 1, 4, 1024, 64, 128, 1)
    assert [l.role for l in by["block_sparse_custom_vjp_n512"].launches] == ["K4", "K5a", "K5b"]
    # K1's backward at a one-pass shape: bf16 the one-pass kernel, f32 K3a
    # and K3b, then on both the dsum pass
    assert [(l.role, l.dtypes) for l in by["fused_axial_bwd_256"].launches] == [
        ("K1", lowering.DTYPES), ("K3", ("bfloat16",)), ("K3a", ("float32",)),
        ("K3b", ("float32",)), ("K3d", lowering.DTYPES)]
    assert by["tied_row_fwd_256"].launches[0].args == (None, 1, 8, 4, 256, 256, 64, 1)  # R*D 512
    # K2's backward at JAX's case_tied_row_bwd shape, R*D 512, and at the
    # training shape, R*D 320: K2 with lse, then dq (K2a) and dk/dv (K2b),
    # each planned with its fused axis, its row width (D) and TMA-aligned
    # operands; at R*D 512 the backward takes the wide route, whose later
    # passes (p and ds, K2g; the dq and dk/dv products) plan in bf16
    assert [(l.role, l.source, l.symbol, l.args, l.dtypes)
            for l in by["tied_row_bwd_256"].launches] == [
        ("K2", "tied_row_attention", "af2_tied_row_attention_plan",
         (None, 1, 8, 4, 256, 256, 64, 1), lowering.DTYPES),
        ("K2a", "tied_row_attention_bwd", "af2_tied_row_attention_bwd_plan",
         (0, None, 1, 4, 256, 256, 512, 64, 1), lowering.DTYPES),
        ("K2b", "tied_row_attention_bwd", "af2_tied_row_attention_bwd_plan",
         (1, None, 1, 4, 256, 256, 512, 64, 1), lowering.DTYPES),
        *((role, "tied_row_attention_bwd", "af2_tied_row_attention_bwd_wide_pass",
           (pass_, None, 1, 4, 256, 256, 512, 64, 1), ("bfloat16",))
          for role, pass_ in (("K2g", 1), ("K2a", 2), ("K2b", 3)))]
    # the wide forward: the logits through K2's plan, then its softmax and
    # P V' passes in bf16
    assert [(l.symbol, l.args[:2]) for l in by["plm_tied_rows_8192"].launches[:3]] == [
        ("af2_tied_row_attention_plan", (None, 1)),
        ("af2_tied_row_attention_wide_pass", (1, None)),
        ("af2_tied_row_attention_wide_pass", (2, None))]
    assert [l.args for l in by["train_tied_rows"].launches] == [
        (None, 1, 5, 8, 64, 64, 64, 1), (0, None, 1, 8, 64, 64, 320, 64, 1),
        (1, None, 1, 8, 64, 64, 320, 64, 1)]
    # past head dim 128, K3a/K3b plan tied_row_attention_bwd.cu's kernels on
    # the head dim as 4 rows of 64, and so does bf16 K1 K2's forward plan (the
    # strided entry's); f32 K1 stays on fused_attention.cu's D-chunked kernel
    assert [(l.role, l.source, l.args, l.dtypes) for l in by["edge_dense_d256"].launches] == [
        ("K1", "fused_attention", (None, 1, 2, 130, 130, 256, 1, 1), ("float32",)),
        ("K1", "tied_row_attention", (None, 1, 4, 2, 130, 130, 64, 1), ("bfloat16",)),
        ("K3a", "tied_row_attention_bwd", (0, None, 1, 2, 130, 130, 256, 64, 1), lowering.DTYPES),
        ("K3b", "tied_row_attention_bwd", (1, None, 1, 2, 130, 130, 256, 64, 1), lowering.DTYPES),
        ("K3d", "fused_attention_bwd", (None, 1, 2, 130, 256), lowering.DTYPES)]
    assert by["serve_cross_msa_from_pair"].launches[0].args == (None, 4, 8, 640, 147456, 64, 2, 1)
    # the short passes plan K1 (the packed kernel) with no split
    assert by["template_axis"].launches[0].args == (None, 147456, 8, 5, 5, 64, 1, 1)
    assert by["config4_msa_column"].launches[0].args == (None, 128, 8, 16, 16, 64, 1, 1)
    assert by["scale_rows_4x512"].dtypes == ("float32",)
    every = {l.source for c in lowering.CASES for l in c.launches}
    assert every == set(build.SIGNATURES)  # every kernel source is gated
    for c in lowering.CASES:
        if c.launches:
            assert set(c.dtypes) <= {"float32", "bfloat16"}
            assert all(build.SIGNATURES[l.source].get(l.symbol) for l in c.launches)
    # K1 plans with its key split and TMA-aligned operands
    assert by["flash_axial_256"].launches[0].plan_args("bfloat16") == (
        1, 4, 8, 256, 256, 64, 1, 1)


@pytest.mark.parametrize("case,splits", [
    ("serve_cross_msa_from_pair", 2), ("train_cross_msa_from_pair", 11),
    ("serve_pair_axial_384", 1), ("serve_msa_column", 1), ("train_msa_column", 1),
    ("train_pair_axial_128", 1), ("serve_cross_pair_from_msa", 1),
])
def test_k1_lists_its_combine_pass_where_the_key_axis_splits(case, splits):
    """Wherever key_splits cuts the key axis, the case plans K1 with that
    split and then K1's combine pass (bf16 only); elsewhere K1 alone."""
    launches = {c.name: c for c in lowering.CASES}[case].launches
    k1 = [l for l in launches if l.role.startswith("K1")]
    assert k1[0].role == "K1" and k1[0].args[6:] == (splits, 1)
    if splits == 1:
        assert len(k1) == 1
    else:
        b, h, nq, _, d = k1[0].args[1:6]
        assert [l.role for l in k1] == ["K1", "K1c"]
        assert k1[1].symbol == "af2_fused_attention_combine_plan"
        assert k1[1].args == (b, h, nq, d) and k1[1].dtypes == ("bfloat16",)


@pytest.mark.parametrize("case,splits", [
    ("train_cross_pair_from_msa", (1, 7)), ("train_cross_msa_from_pair", (7, 1)),
    ("train_pair_axial_128", (1, 1)), ("train_msa_column", (1, 1)), ("train_msa_row", (1, 1)),
    ("flash_bwd_256", (1, 1)), ("fused_axial_bwd_256", (1, 1)), ("edge_dense_d128", (1, 1)),
])
def test_k3_lists_its_merge_pass_where_it_splits(case, splits):
    """K3a and K3b plan with grad_splits' count and TMA-aligned operands;
    wherever one splits, K3's merge pass follows it (bf16 only) under its
    own role, K3m: one output (dq) after K3a, two (dk, dv) after K3b. At a
    shape grad_route sends to the one-pass kernel, bf16 plans that kernel
    (K3, with its cluster) and no split or merge, and K3a/K3b plan in f32
    alone, whole. The dsum pass (K3d) closes every backward."""
    every = {c.name: c for c in lowering.CASES}[case].launches
    launches = [l for l in every if l.role in ("K3", "K3a", "K3b", "K3m")]
    assert [l.role for l in every if l.role.startswith("K3")][-1] == "K3d"
    k3a = next(l for l in launches if l.role == "K3a")
    b, h, nq, nk, d = k3a.args[2:7]
    if axial.grad_route(b, h, nq, nk, d) == "onepass":
        assert [(l.role, l.dtypes) for l in launches] == [
            ("K3", ("bfloat16",)), ("K3a", ("float32",)), ("K3b", ("float32",))]
        assert launches[0].symbol == "af2_fused_attention_bwd_onepass_plan"
        assert launches[0].args == (None, b, h, nq, nk, d, 1)
        assert [l.args for l in launches[1:]] == [(0, None, b, h, nq, nk, d, 1, 1),
                                                  (1, None, b, h, nq, nk, d, 1, 1)]
        return
    roles = ["K3a"] + ["K3m"] * (splits[0] > 1) + ["K3b"] + ["K3m"] * (splits[1] > 1)
    assert [l.role for l in launches] == roles
    main = [l for l in launches if l.role != "K3m"]
    assert [l.args for l in main] == [(0, None, b, h, nq, nk, d, splits[0], 1),
                                      (1, None, b, h, nq, nk, d, splits[1], 1)]
    assert all(l.symbol == "af2_fused_attention_bwd_plan" for l in main)
    merges = [l for l in launches if l.role == "K3m"]
    want = [(1, b, h, nq, d)] * (splits[0] > 1) + [(2, b, h, nk, d)] * (splits[1] > 1)
    assert [l.args for l in merges] == want
    assert all(l.symbol == "af2_fused_attention_bwd_merge_plan" and l.dtypes == ("bfloat16",)
               for l in merges)


@pytest.mark.parametrize("case", [
    "block_sparse_bwd_n512", "block_sparse_bwd_n1024", "block_sparse_custom_vjp_n512",
    "sparse_train_pair_128", "sparse_pair_512", "edge_sparse_block128_d128",
])
def test_k5_plans_with_tma_aligned_operands(case):
    """K5a and K5b plan at the case's shape with operands TMA can describe
    (the ``aligned`` argument), so bf16 at head dim 32, 64 or 128 plans the
    Hopper kernels; both dtypes launch them."""
    launches = [l for l in {c.name: c for c in lowering.CASES}[case].launches
                if l.role.startswith("K5")]
    k4 = {c.name: c for c in lowering.CASES}[case].launches[0]
    b, h, n, d, block = k4.args[1:6]
    assert [l.role for l in launches] == ["K5a", "K5b"]
    assert [l.args for l in launches] == [(0, None, b, h, n, d, block, 1),
                                          (1, None, b, h, n, d, block, 1)]
    assert all(l.symbol == "af2_block_sparse_attention_bwd_plan" and l.dtypes == lowering.DTYPES
               for l in launches)
    assert launches[1].plan_args("bfloat16") == (1, 1, b, h, n, d, block, 1)
    assert len(build.SIGNATURES["block_sparse_attention_bwd"][launches[0].symbol]) == 9


@pytest.mark.parametrize("case", [
    "block_sparse_fwd_n512", "block_sparse_fwd_nolse_n512", "block_sparse_fwd_n1024",
    "block_sparse_bwd_n512", "block_sparse_bwd_n1024", "block_sparse_custom_vjp_n512",
    "sparse_train_pair_128", "sparse_pair_512", "edge_sparse_block128_d128",
])
def test_k4_plans_with_tma_aligned_operands(case):
    """K4 plans at the case's shape with operands TMA can describe (the
    ``aligned`` argument), so bf16 at head dim 32, 64 or 128 plans the Hopper
    kernel; both dtypes launch it."""
    k4 = {c.name: c for c in lowering.CASES}[case].launches[0]
    assert k4.role == "K4" and k4.source == "block_sparse_attention"
    assert k4.symbol == "af2_block_sparse_attention_plan" and k4.dtypes == lowering.DTYPES
    b, h, n, d, block = k4.args[1:6]
    assert k4.args == (None, b, h, n, d, block, 1)
    assert k4.plan_args("bfloat16") == (1, b, h, n, d, block, 1)
    assert k4.plan_args("float32") == (0, b, h, n, d, block, 1)
    assert len(build.SIGNATURES["block_sparse_attention"][k4.symbol]) == 8
    assert len(build.SIGNATURES["block_sparse_attention"]["af2_block_sparse_attention"]) == 23


# ------------------------------------------------------------ ptxas report


def test_parse_ptxas_report():
    entries = lowering.parse_ptxas(REPORT)
    assert list(entries) == [DKV, DQ, X, MISTILED]
    dkv = entries[DKV]
    assert (dkv.registers, dkv.barriers, dkv.stack_frame, dkv.spill_stores,
            dkv.spill_loads, dkv.static_smem) == (255, 16, 40, 38, 80, 0)
    dq = entries[DQ]
    assert (dq.registers, dq.barriers, dq.stack_frame, dq.spill_stores) == (168, 16, 0, 0)
    assert (entries[X].registers, entries[X].barriers, entries[X].static_smem) == (10, 0, 0)
    assert (entries[MISTILED].registers, entries[MISTILED].static_smem) == (16, 65536)


def test_report_by_kernel_names_instantiations_as_the_plans_do():
    report = lowering.report_by_kernel(REPORT, _demangle)
    assert set(report) == {"dq_kernel<__nv_bfloat16,64,128>", "dkv_kernel<__nv_bfloat16,64,128>",
                           "scale_rows", "scale_rows_mistiled"}
    assert report["scale_rows"].demangled == DEMANGLED[X]


@pytest.mark.parametrize("demangled,key", [
    ("void af2::attention_kernel_mma<64>(af2::Problem, int)", "attention_kernel_mma<64>"),
    ("void af2::attention_kernel<128>(af2::Problem)", "attention_kernel<128>"),
    ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 16, 64>((anonymous namespace)::Fwd,"
     " int)", "fwd_kernel<__nv_bfloat16,16,64>"),
    ("void _GLOBAL__N__1b2c_7_k_cu::dq_kernel_mma<32>(_GLOBAL__N__1b2c_7_k_cu::Grad, int)",
     "dq_kernel_mma<32>"),
    ("void af2::attention_kernel_mma<(int)64>(af2::Problem, int)", "attention_kernel_mma<64>"),
    (K1_DEMANGLED[SM90], "attention_kernel_sm90<64>"),
    (K3_DEMANGLED[K3_DKV], "dkv_kernel_sm90<64>"),
    (K4_DEMANGLED[K4_FWD], "sparse_fwd_kernel_sm90<64>"),
    ("void <unnamed>::fwd_kernel<float, (int)16, (int)64>(<unnamed>::Fwd, int)",
     "fwd_kernel<float,16,64>"),
    ("scale_rows(float const*, float*, int)", "scale_rows"),
])
def test_kernel_key(demangled, key):
    assert lowering.kernel_key(demangled) == key


def test_k1_hopper_kernels_fit_sm90():
    """K1's plans at the serving MSA<-pair pass (288 threads, 115,832 bytes
    of dynamic shared memory, 640 blocks at 2 key splits; the combine pass
    160 blocks of 128) against ptxas's report of their instantiations."""
    report = lowering.report_by_kernel(K1_REPORT, lambda names: {
        n: K1_DEMANGLED[n] for n in names})
    assert set(report) == {"attention_kernel_sm90<64>", "combine_kernel<64>"}
    main = {"blocks": 640, "threads": 288, "dynamic_smem": 115_832,
            "kernel": "attention_kernel_sm90<64>"}
    combine = {"blocks": 160, "threads": 128, "dynamic_smem": 0,
               "kernel": "combine_kernel<64>"}
    assert lowering.check_launch(main, report[main["kernel"]]) == []
    assert lowering.check_launch(combine, report[combine["kernel"]]) == []
    sm90 = report["attention_kernel_sm90<64>"]
    assert (sm90.registers, sm90.spill_stores, sm90.spill_loads) == (123, 0, 0)
    assert sm90.registers * main["threads"] <= lowering.SM90_LIMITS["registers_per_sm"]


def test_k3_hopper_kernels_fit_sm90():
    """K3's plans at the two cross passes (K3a at MSA<-pair, K3b at
    pair<-MSA: 280 blocks of 160 threads at 7 splits, 68,208 bytes of
    dynamic shared memory; the merge pass 160 and 320 blocks of 128) against
    ptxas's report of their instantiations: no spill, and two blocks fit an
    SM in registers and shared memory."""
    report = lowering.report_by_kernel(K3_REPORT, lambda names: {
        n: K3_DEMANGLED[n] for n in names})
    assert set(report) == {"dq_kernel_sm90<64>", "dkv_kernel_sm90<64>", "grad_merge_kernel<64>"}
    plans = [{"blocks": 280, "threads": 160, "dynamic_smem": 68_208,
              "kernel": "dq_kernel_sm90<64>"},
             {"blocks": 280, "threads": 160, "dynamic_smem": 68_208,
              "kernel": "dkv_kernel_sm90<64>"},
             {"blocks": 160, "threads": 128, "dynamic_smem": 0, "kernel": "grad_merge_kernel<64>"},
             {"blocks": 320, "threads": 128, "dynamic_smem": 0, "kernel": "grad_merge_kernel<64>"}]
    for plan in plans:
        res = report[plan["kernel"]]
        assert lowering.check_launch(plan, res) == []
        assert (res.spill_stores, res.spill_loads, res.stack_frame) == (0, 0, 0)
    for name in ("dq_kernel_sm90<64>", "dkv_kernel_sm90<64>"):
        assert 2 * report[name].registers * 160 <= lowering.SM90_LIMITS["registers_per_sm"]
    # an SM's 228 KiB of shared memory, 1 KiB of it reserved per block
    assert 2 * (68_208 + 1024) <= 228 * 1024


def test_k5_hopper_kernels_fit_sm90():
    """K5's plans at the sparse training pass (2048 blocks of 160 threads,
    one per 64-row tile of 128 x 8 heads x 128 tokens; 68,272 bytes of
    dynamic shared memory, K3's ring with a mask word set per consumer
    warp) against ptxas's report of their instantiations: K3's registers
    (124 and 168), no spill, and two blocks fit an SM."""
    report = lowering.report_by_kernel(K5_REPORT, lambda names: {
        n: K5_DEMANGLED[n] for n in names})
    assert set(report) == {"sparse_dq_kernel_sm90<64>", "sparse_dkv_kernel_sm90<64>"}
    for name, registers in (("sparse_dq_kernel_sm90<64>", 124),
                            ("sparse_dkv_kernel_sm90<64>", 168)):
        plan = {"blocks": 2048, "threads": 160, "dynamic_smem": 68_272, "kernel": name}
        res = report[name]
        assert lowering.check_launch(plan, res) == []
        assert (res.registers, res.spill_stores, res.spill_loads, res.stack_frame) == (
            registers, 0, 0, 0)
        assert 2 * res.registers * 160 <= lowering.SM90_LIMITS["registers_per_sm"]
    assert 2 * (68_272 + 1024) <= 228 * 1024


def test_k4_hopper_kernel_fits_sm90():
    """K4's plan at the sparse training pass (2048 blocks of 160 threads,
    one per 64-query tile of 128 x 8 heads x 128 tokens; 60,080 bytes of
    dynamic shared memory: the q tile, a 3-stage K/V ring and K5's ring
    control with a mask word set per consumer warp) against ptxas's report
    of its instantiation: no spill, and three blocks fit an SM in registers
    and shared memory."""
    report = lowering.report_by_kernel(K4_REPORT, lambda names: {
        n: K4_DEMANGLED[n] for n in names})
    assert set(report) == {"sparse_fwd_kernel_sm90<64>"}
    plan = {"blocks": 2048, "threads": 160, "dynamic_smem": 60_080,
            "kernel": "sparse_fwd_kernel_sm90<64>"}
    res = report[plan["kernel"]]
    assert lowering.check_launch(plan, res) == []
    assert (res.registers, res.spill_stores, res.spill_loads, res.stack_frame) == (108, 0, 0, 0)
    assert 3 * res.registers * 160 <= lowering.SM90_LIMITS["registers_per_sm"]
    assert 3 * (60_080 + 1024) <= 228 * 1024


@pytest.mark.parametrize("case,kernel", [
    ("serve_tied_rows", "tied_row_attention_kernel_sm90<64,128>"),
    ("train_tied_rows", "tied_row_attention_kernel_sm90<64,64>"),
    ("tied_row_fwd_256", "tied_row_attention_kernel_sm90<64,64>"),
    ("tied_row_bwd_256", "tied_row_attention_kernel_sm90<64,64>"),
    ("edge_tied_rows_1280", "tied_wide_logits_kernel<64,2>"),
    ("plm_tied_rows_8192", "tied_wide_logits_kernel<64,2>"),
    ("edge_tied_rows_wide_d32", "tied_wide_logits_kernel<32,2>"),
    ("edge_tied_rows_wide_d128", "tied_wide_logits_kernel<128,2>"),
])
def test_k2_plans_with_tma_aligned_operands(case, kernel):
    """K2 plans at the case's shape with operands TMA can describe (the
    ``aligned`` argument), so bf16 at R*D up to 512 plans the Hopper kernel
    (the instantiation tied_row.hopper_plan names, as the C plan does on the
    card) and a wider R*D the wide route (its logits pass, as
    tied_row.wide_plan names it); both dtypes launch it."""
    k2 = {c.name: c for c in lowering.CASES}[case].launches[0]
    assert k2.role == "K2" and k2.source == "tied_row_attention"
    assert k2.symbol == "af2_tied_row_attention_plan" and k2.dtypes == lowering.DTYPES
    _, b, r, h, nq, nk, d, aligned = k2.args
    assert aligned == 1 and nq == nk
    assert k2.plan_args("bfloat16") == (1, b, r, h, nq, nk, d, 1)
    assert len(build.SIGNATURES["tied_row_attention"][k2.symbol]) == 9
    plan = tied_row.hopper_plan(b, r, h, nq, d) or tied_row.wide_plan(b, r, h, nq, nk, d)
    assert plan["kernel"] == kernel


def test_k2_hopper_kernel_fits_sm90():
    """K2's plans at the serving tied pass (192 blocks of 160 threads, 3
    column groups of 128, one stage: 99,392 bytes of dynamic shared memory),
    the tied training pass (40 blocks, 5 groups of 64, two stages: 140,352
    bytes) and JAX's gate shape (128 blocks, 8 groups of 64, 214,080 bytes)
    against ptxas's report of their instantiations: no spill, and the
    serving pass's blocks fit two an SM in registers and shared memory."""
    report = lowering.report_by_kernel(K2_REPORT, lambda names: {
        n: K2_DEMANGLED[n] for n in names})
    assert set(report) == {"tied_row_attention_kernel_sm90<64,128>",
                           "tied_row_attention_kernel_sm90<64,64>"}
    plans = [{"blocks": 192, "threads": 160, "dynamic_smem": 99_392,
              "kernel": "tied_row_attention_kernel_sm90<64,128>"},
             {"blocks": 40, "threads": 160, "dynamic_smem": 140_352,
              "kernel": "tied_row_attention_kernel_sm90<64,64>"},
             {"blocks": 128, "threads": 160, "dynamic_smem": 214_080,
              "kernel": "tied_row_attention_kernel_sm90<64,64>"}]
    for plan, shape in zip(plans, ((4, 5, 8, 128, 64), (1, 5, 8, 64, 64), (1, 8, 4, 256, 64))):
        mirror = tied_row.hopper_plan(*shape)
        assert {k: mirror[k] for k in plan} == plan
        res = report[plan["kernel"]]
        assert lowering.check_launch(plan, res) == []
        assert (res.spill_stores, res.spill_loads, res.stack_frame) == (0, 0, 0)
        assert res.registers * 160 <= lowering.SM90_LIMITS["registers_per_sm"]
        assert plan["dynamic_smem"] + 1024 <= 228 * 1024
    assert (report["tied_row_attention_kernel_sm90<64,128>"].registers,
            report["tied_row_attention_kernel_sm90<64,64>"].registers) == (138, 106)
    assert 2 * 138 * 160 <= lowering.SM90_LIMITS["registers_per_sm"]
    assert 2 * (99_392 + 1024) <= 228 * 1024


# ------------------------------------------------------------ limits


GOOD = {"blocks": 128, "threads": 128, "dynamic_smem": 50_000, "kernel": "k<64>"}


def _res(**kw):
    return lowering.Resources("k", **{"registers": 128, **kw})


def test_a_plan_within_the_limits_passes():
    assert lowering.check_launch(GOOD, _res(static_smem=1024)) == []
    # the largest legal launch: 1024 threads of 64 registers, 227 KiB
    edge = dict(GOOD, blocks=2**31 - 1, threads=1024, dynamic_smem=232_448)
    assert lowering.check_launch(edge, _res(registers=64)) == []


@pytest.mark.parametrize("plan,res,needle", [
    (dict(GOOD, blocks=0), _res(), "0 blocks"),
    (dict(GOOD, blocks=2**31), _res(), "2147483648 blocks"),
    (dict(GOOD, threads=2048), _res(registers=16), "2048 threads"),
    (dict(GOOD, threads=100), _res(), "100 threads"),
    (dict(GOOD, dynamic_smem=240 * 1024), _res(), "> 232448"),
    (GOOD, _res(static_smem=64 * 1024), "static shared memory > 49152"),
    (dict(GOOD, threads=1024), _res(registers=255), "255 registers x 1024 threads"),
    (GOOD, _res(registers=256), "256 registers a thread > 255"),
    (GOOD, None, "not in ptxas's report"),
    (dict(GOOD, blocks=64, cluster=16), _res(), "a cluster of 16 blocks"),
    (dict(GOOD, blocks=66, cluster=4), _res(), "a cluster of 4 blocks over 66"),
])
def test_each_broken_limit_fails(plan, res, needle):
    problems = lowering.check_launch(plan, res)
    assert problems and any(needle in p for p in problems), problems


# ------------------------------------------------------------ negative control


def test_shared_data_refusal_is_a_rejection():
    assert lowering._is_hopper_rejection(2, "nvcc output\n" + REFUSAL)


@pytest.mark.parametrize("code,log", [
    (0, REFUSAL),  # built: never a rejection
    (None, REFUSAL + "\nnvcc timed out after 600 s"),  # timed out
    (127, "/bin/sh: 1: nvcc: not found"),  # no compiler
    (1, "scale_rows_mistiled.cu(25): error: identifier \"tile\" is undefined"),  # a C++ error
    (1, "fatal error: ../launch_plan.cuh: No such file or directory"),  # a missing header
    (2, REFUSAL.replace("scale_rows_mistiled", "other_kernel")),  # another kernel's refusal
    (2, REFUSAL.replace("0x10000 bytes", "0x8000 bytes")),  # not over the limit
])
def test_anything_else_is_not_a_rejection(code, log):
    assert not lowering._is_hopper_rejection(code, log)


def _fake_nvcc(tmp_path, body):
    """A stand-in compiler: a script that prints ``body`` and exits as it
    says, so the control's path runs without the toolkit."""
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.mark.parametrize("body,ok", [
    (f"import sys; print({REFUSAL!r}); sys.exit(255)", True),
    ("import sys; print('x.cu(3): error: expected a \";\"'); sys.exit(1)", False),
    ("import sys; sys.exit(0)", False),
])
def test_run_control_classifies_the_compiler(tmp_path, monkeypatch, body, ok):
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path, body))
    rec = lowering.run_control(tmp_path / "out")
    assert rec["case"] == lowering.CONTROL_CASE and rec["ok"] is ok
    assert (rec["status"] == "ok") is ok
    if not ok:
        assert "BUILT" in rec["error"] or "another reason" in rec["error"]


def test_compile_source_returns_none_on_timeout(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "nvcc_path",
                        lambda: _fake_nvcc(tmp_path, "import time; time.sleep(30)"))
    code, log = build.compile_source(build.MISTILED, tmp_path, timeout=1)
    assert code is None and "timed out" in log
    assert not lowering._is_hopper_rejection(code, log)


# ------------------------------------------------------------ the gate, faked


class _FakeLib:
    """Plan entries that fill the struct as the C code would."""

    def __init__(self, plans):
        self.plans = plans

    def __getattr__(self, symbol):
        def entry(*args):
            at = next(i for i, a in enumerate(args) if hasattr(a, "_obj"))  # the plan's pointer
            out = args[at]._obj
            plan = self.plans(symbol, args[:at])
            out.blocks, out.threads, out.dynamic_smem = plan[:3]
            out.kernel = plan[3].encode()
            return 0
        return entry


def test_run_gate_assembles_cases(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "/fake/nvcc")
    monkeypatch.setattr(build, "build_sources",
                        lambda names: {n: (0, REPORT, tmp_path / f"{n}.so") for n in names})

    def plans(symbol, args):
        if symbol == "af2_scale_rows_plan":
            return (args[0], args[1], 0, "scale_rows")
        return (10, 128, 1000, "dq_kernel<__nv_bfloat16,64,128>")

    monkeypatch.setattr(build, "library", lambda name: _FakeLib(plans))
    monkeypatch.setattr(lowering, "run_control",
                        lambda: {"case": lowering.CONTROL_CASE, "ok": True, "status": "ok"})
    records, summary = lowering.run_gate(("scale_rows_4x512", "tied_row_bwd_256",
                                          "block_sparse_bwd_n512", lowering.CONTROL_CASE),
                                         demangle=_demangle)
    by = {r["case"]: r for r in records}
    x = by["scale_rows_4x512"]["launches"]
    assert len(x) == 1 and x[0]["blocks"] == 4 and x[0]["threads"] == 512
    assert x[0]["registers"] == 10 and x[0]["static_smem"] == 0 and x[0]["problems"] == []
    assert x[0]["demangled"] == DEMANGLED[X]
    assert by["scale_rows_4x512"]["ok"]
    # 3 launches x 2 dtypes, all naming dq_kernel<__nv_bfloat16,64,128>, which the report has
    assert len(by["block_sparse_bwd_n512"]["launches"]) == 6 and by["block_sparse_bwd_n512"]["ok"]
    tied = by["tied_row_bwd_256"]
    # f32 plans the three chunked launches; bf16 the wide backward's passes too
    assert tied["ok"] and [r["role"] for r in tied["launches"]] == (
        ["K2", "K2a", "K2b"] + ["K2", "K2a", "K2b", "K2g", "K2a", "K2b"])
    assert summary == {"gate": "hopper_build", "cases": 4, "failed": [],
                       "control_rejected": True}


@pytest.mark.parametrize("case,shape,splits", [
    ("split_msa_rows_320", (1, 5, 8, 64, 64), 3),
    ("split_plm_rows_8192", (1, 128, 8, 128, 64), 8),
])
def test_k2_split_route_is_gated_at_the_training_shapes(case, shape, splits):
    """K2's split passes (MSA rows sharded over a mesh) at the shapes the
    card trains: the logits (the Hopper route in feature splits, then their
    sum in bf16), the softmax, the grad and the product, each planned by
    ``af2_tied_split_plan`` with the Hopper route asked for, as the
    ``tied_split_*`` wrappers plan them, and null split and workspace
    pointers after the plan's."""
    b, r, h, n, d = shape
    launches = {c.name: c for c in lowering.CASES}[case].launches
    assert [(l.role, l.source, l.symbol, l.args[0], l.dtypes, l.tail) for l in launches] == [
        ("K2s", "tied_row_attention", "af2_tied_split_plan", pass_, dtypes, (None, None))
        for pass_, dtypes in ((0, lowering.DTYPES), (1, ("bfloat16",)), (2, lowering.DTYPES),
                              (3, lowering.DTYPES), (4, lowering.DTYPES))]
    assert all(l.args[1:] == (None, b, h, n, n, r * d, d, 1) for l in launches)
    assert len(build.SIGNATURES["tied_row_attention"]["af2_tied_split_plan"]) == 12
    assert tied_row.split_logits_splits(b, h, n, n, r * d, d) == splits
    assert tied_row._wide(False, b, h, n, n, r * d, d)["kernel"] == "tied_wide_logits_kernel<64,2>"


def test_run_gate_passes_the_split_plans_null_tails(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "/fake/nvcc")
    monkeypatch.setattr(build, "build_sources",
                        lambda names: {n: (0, REPORT, tmp_path / f"{n}.so") for n in names})
    seen = []

    class Lib(_FakeLib):
        def __getattr__(self, symbol):
            entry = super().__getattr__(symbol)

            def call(*args):
                seen.append(args)
                return entry(*args)
            return call

    monkeypatch.setattr(build, "library", lambda name: Lib(
        lambda symbol, args: (10, 128, 1000, "dq_kernel<__nv_bfloat16,64,128>")))
    records, summary = lowering.run_gate(("split_msa_rows_320",), demangle=_demangle)
    assert summary["failed"] == [] and len(records[0]["launches"]) == 9  # 4 f32, 5 bf16
    assert all(len(a) == 12 and a[10:] == (None, None) for a in seen)


def test_run_gate_fails_a_kernel_missing_from_the_report(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "/fake/nvcc")
    monkeypatch.setattr(build, "build_sources",
                        lambda names: {n: (0, REPORT, tmp_path / f"{n}.so") for n in names})
    monkeypatch.setattr(build, "library", lambda name: _FakeLib(
        lambda symbol, args: (8, 128, 0, "fwd_kernel<float,64,64>")))
    records, summary = lowering.run_gate(("block_sparse_fwd_n512",), demangle=_demangle)
    assert summary["failed"] == ["block_sparse_fwd_n512"]
    assert "never built" in records[0]["launches"][0]["problems"][0]


def test_run_gate_reports_spills_as_warnings(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "/fake/nvcc")
    monkeypatch.setattr(build, "build_sources",
                        lambda names: {n: (0, REPORT, tmp_path / f"{n}.so") for n in names})
    monkeypatch.setattr(build, "library", lambda name: _FakeLib(
        lambda symbol, args: (8, 128, 0, "dkv_kernel<__nv_bfloat16,64,128>")))
    records, summary = lowering.run_gate(("block_sparse_fwd_n512",), demangle=_demangle)
    assert summary["failed"] == [] and records[0]["ok"]
    assert "38 bytes spill stores, 80 bytes spill loads" in records[0]["warning"][0]


def test_a_source_that_does_not_build_fails_its_cases(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "/fake/nvcc")
    monkeypatch.setattr(build, "build_sources", lambda names: {
        n: (1, "x.cu(1): error: bad", tmp_path / f"{n}.so") for n in names})
    records, summary = lowering.run_gate(("flash_axial_256",), demangle=_demangle)
    assert summary["failed"] == ["flash_axial_256"]
    assert "did not build" in records[0]["launches"][0]["problems"][0]


# ------------------------------------------------------------ CLI


def test_cli_exits_2_naming_nvcc_without_it(monkeypatch, capsys):
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    assert lowering.main([]) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["gate"] == "hopper_build" and "nvcc" in line["error"]


def test_cli_exits_2_on_an_unknown_case(capsys):
    assert lowering.main(["flash_axial_265"]) == 2
    assert "unknown case" in capsys.readouterr().out


def test_cli_without_nvcc_in_a_fresh_process(tmp_path):
    """On a machine without the CUDA toolkit, in a fresh process: exit 2."""
    import subprocess

    if build.nvcc_path() is not None:
        pytest.skip("this machine has nvcc: the gate would build")
    proc = subprocess.run([sys.executable, "-m", "alphafold2_tpu_torch.analysis.lowering"],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 2 and "nvcc" in proc.stdout


# ------------------------------------------------------------ X


def test_x_plain_version_equals_the_pallas_kernel_bitwise():
    """X's kernel body (alphafold2_tpu/analysis/lowering.py:263-264) with
    its BlockSpecs at (4, 512), in interpret mode, against the port's plain
    version and its wrapper on the CPU."""

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    x = np.random.default_rng(0).standard_normal((4, 512)).astype(np.float32)
    ref = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((4, 512), jnp.float32),
        grid=(4,),
        in_specs=[pl.BlockSpec((1, 512), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, 512), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(x))
    ref = np.asarray(ref)
    calls = controls.scale_rows_reference.calls
    plain = controls.scale_rows_reference(torch.from_numpy(x)).numpy()
    wrapped = controls.scale_rows(torch.from_numpy(x)).numpy()
    assert plain.dtype == ref.dtype == np.float32
    assert np.array_equal(plain.view(np.uint32), ref.view(np.uint32))
    assert np.array_equal(wrapped.view(np.uint32), ref.view(np.uint32))
    assert controls.scale_rows_reference.calls == calls + 2  # the CPU takes the plain version


def test_x_wrapper_checks_its_operand():
    with pytest.raises(ValueError):
        controls.scale_rows(torch.ones(4, 512, dtype=torch.float64))
    with pytest.raises(ValueError):
        controls.scale_rows(torch.ones(4, 4, 512))
    assert controls.X_SHAPE == (4, 512) and controls.LAUNCH_CONTROL_SHAPE == (1, 2048)
    assert controls.INVALID_CONFIGURATION == 9


def test_launch_plan_struct_layout():
    # blocks, threads, dynamic_smem, kernel, cluster, then padding to the
    # long long's 8-byte alignment, as the C struct lays them out
    assert ctypes.sizeof(build.LaunchPlan) == 8 + 4 + 4 + 120 + 4 + 4
    assert build.LaunchPlan.cluster.offset == 8 + 4 + 4 + 120
    assert build.SIGNATURES["scale_rows"]["af2_scale_rows_plan"][-1]._type_ is build.LaunchPlan


def test_launch_errors_carry_their_code():
    class Lib:
        @staticmethod
        def af2_error_string(code):
            return b"invalid configuration argument"

    with pytest.raises(build.KernelLaunchError) as e:
        build.check(Lib(), 9, "scale_rows")
    assert e.value.code == 9 and "CUDA error 9" in str(e.value)
    build.check(Lib(), 0, "scale_rows")
