"""The model axis for the audio and vlm families in the port (each
codebook's table and head vocabulary-sharded, the codebooks' logits
constrained on their vocabulary; the replicated patch prefix beside the
vocabulary-sharded text, the tied head's logits and the loss over the text
tail) on the CPU: gloo worlds of 2 and 4 processes against one process and
against the reference, by the machinery of
``test_torch_tensor_parallel_ssm.py``.

The reference's steps (in this process, jitted) are the oracle, for the
smoke variants of musicgen-medium (4 codebooks: tokens and labels [B, S,
4]) and paligemma-3b (8 patches of 32 before 24 text tokens, embeddings
tied, a vocabulary of 250 in a table of 256 rows, so the loss and the
argmax run on the padded shards and the logits are cut for the caller by
the neighbour shift): three train steps from its own initial parameters, and its prefill
then four greedy serve steps.  In separate interpreters, one world a mesh
for both configurations:

- the train cell on (data 1, model 2) and on (2, 2): losses and grad norms
  within 1e-6 relative of one process's unsharded step, parameters within
  C.18's bar of the reference's and of one process's;
- the prefill and decode cells on (1, 2): logits and KV caches within 1e-5
  of the reference's, the greedy tokens (one a codebook) equal;
- the tables and heads on the placements the reference's specs give, and
  a model drawn sharded (``init_sharded``) equal to the one drawn whole.
"""

from __future__ import annotations

import pytest

from test_torch_tensor_parallel_ssm import (WORLDS, all_runs, check_decode, check_prefill,
                                            check_train_metrics, check_train_params,
                                            reference_runs)

# name: (arch, fields replaced in its smoke variant, sequence length)
CASES = {
    "musicgen-medium": ("musicgen-medium", {}, 32),
    # 8 patches, then 24 text tokens; a vocabulary (250) with pad rows in the tied table
    "paligemma-3b": ("paligemma-3b", {"vocab_size": 250}, 32),
}


@pytest.fixture(scope="module")
def reference():
    return reference_runs(CASES)


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    return all_runs(CASES, reference, tmp_path_factory)


TRAIN = [(c, m) for c in CASES for m in WORLDS]


@pytest.mark.parametrize("case,mesh", TRAIN)
def test_train_cell_equals_one_process_and_the_reference(reference, runs, case, mesh):
    check_train_metrics(reference[case], runs[case], mesh)


@pytest.mark.parametrize("case,mesh", TRAIN)
def test_train_cell_parameters_within_the_reference_bar(reference, runs, case, mesh):
    check_train_params(reference[case], runs[case], mesh)


@pytest.mark.parametrize("case", CASES)
def test_prefill_cell_equals_the_reference(reference, runs, case):
    check_prefill(reference[case], runs[case]["1x2"])


@pytest.mark.parametrize("case", CASES)
def test_decode_cell_equals_the_reference(reference, runs, case):
    check_decode(reference[case], runs[case]["1x2"])


def test_the_codebook_tables_and_heads_are_vocabulary_sharded(runs):
    """musicgen: ``embed`` [K, V, D] and ``heads`` [K, D, V] on V; the greedy
    tokens one a codebook."""
    got = runs["musicgen-medium"]["1x2"]
    assert got["placements"]["embed"] == ["Shard(dim=1)"]
    assert got["placements"]["heads"] == ["Shard(dim=2)"]
    assert got["tokens"][0].shape == (4, 1, 4)
    assert got["prefill_logits"].shape == (4, 32, 4, 256)


def test_the_patch_prefix_is_replicated_beside_the_sharded_table(runs):
    """paligemma: ``patch_proj`` replicated, the tied ``embed`` on V; the
    prefill's logits and cache cover the patches and the text."""
    got = runs["paligemma-3b"]["1x2"]
    assert got["placements"]["patch_proj"] == ["Replicate()"]
    assert got["placements"]["embed"] == ["Shard(dim=0)"]
    assert "head" not in got["placements"]
    assert got["prefill_logits"].shape[1] == got["prefill_cache"]["k"].shape[2] == 32


@pytest.mark.parametrize("case", CASES)
def test_init_sharded_draws_the_weights_init_params_draws(runs, case):
    assert runs[case]["1x2"]["init_sharded_equal"]
