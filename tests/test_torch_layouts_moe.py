"""The activation-layout policy values on a model axis for the moe family
(deepseek-v2-lite-16b's smoke variant: MLA, 4 experts top-2 plus a shared
one), by the machinery of ``test_torch_layouts.py``: gloo worlds of 2 and 4
processes against one process and against the reference, each variant
under its own policy on both sides.

``moe_impl="dense"`` on a model axis: each rank runs every token through
its d_ff slab of every expert, weighted by the router, the partial sums
reduced once at the output, as gshard's are; on (2, 2) the experts are
also split on E over 'data' (every rank's tokens sent to every rank's
experts).  Under ``sp_activations`` MLA and the experts gather the
sequence at entry and reduce-scatter their partial sums onto the stream.
The train cell runs on (1, 2) and (2, 2), the serving cells on both too
(each data rank its rows of the batch).
"""

from __future__ import annotations

import pytest

from test_torch_layouts import (SERVE, TRAIN, Case, all_runs, check_serve, check_train,
                                reference_runs, serve_params, train_params)

CASES = {
    "deepseek-v2-lite-16b": Case("deepseek-v2-lite-16b", (), 32,
                                 train=(*TRAIN, "dense", "sp+dense"),
                                 serve=(*SERVE, "dense", "sp+dense"),
                                 serve_meshes=("1x2", "2x2")),
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


def test_dense_experts_reduce_their_d_ff_slabs_partial_sums_once_a_layer(runs):
    """A dense prefill on (1, 2): MLA's output and the experts' (routed and
    shared together) are each one all-reduce a layer, beside the
    embedding's; under ``sp_activations`` each is a reduce-scatter."""
    layers = 2
    got = runs["deepseek-v2-lite-16b"]["1x2"]["serve"]
    assert got["dense"]["prefill_collectives"]["c10d_functional.all_reduce"] == 1 + 2 * layers
    sp = got["sp+dense"]["prefill_collectives"]
    assert sp["c10d_functional.reduce_scatter_tensor"] == 1 + 2 * layers
    assert "c10d_functional.all_reduce" not in sp
