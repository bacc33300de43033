"""The activation-layout policy values on a model axis for the ssm and
hybrid families (mamba2-2.7b's and hymba-1.5b's smoke variants; hymba's
prompt of 64 is twice its window, so its ring cache wraps in the prefill
and again while decoding), by the machinery of ``test_torch_layouts.py``:
gloo worlds of 2 and 4 processes against one process and against the
reference, each variant under its own policy on both sides.

Under ``sp_activations`` the Mamba mixer gathers the sequence at entry (its
conv and scan run along it) and its partial sum is reduce-scattered onto
the stream (a hybrid block's two branches together); hymba's sliding
window attends each rank's q rows against the gathered keys, and its ring
is written from them.  A decode step never runs sequence-sharded.
"""

from __future__ import annotations

import pytest

from test_torch_layouts import (Case, all_runs, check_serve, check_train, reference_runs,
                                serve_params, train_params)

CASES = {
    "mamba2-2.7b": Case("mamba2-2.7b", (), 32, train=("sp", "noremat+sp")),
    "hymba-1.5b": Case("hymba-1.5b", (), 64),
}


@pytest.fixture(scope="module")
def reference():
    return reference_runs(CASES)


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    return all_runs(CASES, reference, tmp_path_factory)


@pytest.mark.parametrize("case,variant,mesh", train_params(CASES))
def test_train_cell_under_the_layout_equals_one_process_and_the_reference(reference, runs, case,
                                                                          variant, mesh):
    check_train(reference[case], runs[case], variant, mesh)


@pytest.mark.parametrize("case,variant,mesh", serve_params(CASES))
def test_serving_cells_under_the_layout_equal_one_process_and_the_reference(reference, runs,
                                                                            case, variant, mesh):
    check_serve(reference[case], runs[case], variant, mesh)


def test_the_hymba_ring_wraps_under_sequence_parallelism(runs):
    """The prompt (64) is longer than the window (32): the ring holds the
    window's entries after the prefill and after the decode steps."""
    got = runs["hymba-1.5b"]["1x2"]["serve"]["sp+last"]
    assert got["prefill_cache"]["k"].shape[2] == got["cache"]["k"].shape[2] == 32
