"""The activation-layout policy values on a model axis for the audio and
vlm families (musicgen-medium's smoke variant: 4 codebooks; paligemma-3b's:
8 patches before 24 text tokens, a vocabulary of 250 in a tied table of
256 rows), by the machinery of ``test_torch_layouts.py``: gloo worlds of 2
and 4 processes against one process and against the reference, each
variant under its own policy on both sides.

Under ``prefill_last_logit_only`` audio's logits are [B, 1, K, V] and vlm's
last position is its last text token; under ``sp_activations`` vlm's
replicated patch prefix joins the text before the stream is cut over the
sequence (32 positions of patches and text), and the padded vocabulary's
logits are cut for the caller as the default layout's.
"""

from __future__ import annotations

import pytest

from test_torch_layouts import (B, Case, all_runs, check_serve, check_train, reference_runs,
                                serve_params, train_params)

CASES = {
    "musicgen-medium": Case("musicgen-medium", (), 32),
    "paligemma-3b": Case("paligemma-3b", (("vocab_size", 250),), 32),
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


def test_the_last_position_logits_keep_each_family_s_layout(runs):
    """Audio: [B, 1, K, V], a codebook each; vlm: [B, 1, V] of the 250-word
    vocabulary, the last text token's."""
    audio = runs["musicgen-medium"]["1x2"]["serve"]["sp+last"]["prefill_logits"]
    vlm = runs["paligemma-3b"]["1x2"]["serve"]["last_logit"]["prefill_logits"]
    assert tuple(audio.shape) == (B, 1, 4, 256)
    assert tuple(vlm.shape) == (B, 1, 250)
