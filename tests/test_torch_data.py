"""repro_torch's data (``data/synthetic.py``'s text stream,
``data/pipeline.py``) on the CPU against the reference's.

Every case of the reference's ``tests/test_data.py`` for the text stream
and the pipeline (and its image and modality generators), each also
against the reference's output: the batches bitwise equal for every
(seed, step) tried. The pipeline on the CPU: prefetch order, resume,
tensors on the device asked for, numpy without one; ``process_slice``
from explicit indices and from an initialized ``torch.distributed``
group (gloo, one process, a file store).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.configs import smoke_variant
from repro.data import synthetic as jsyn
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import (SyntheticTextConfig, _zipf_probs,
                                        modality_batch, synthetic_digits,
                                        synthetic_lm_batch,
                                        synthetic_lm_batches,
                                        synthetic_textures)


def test_lm_stream_deterministic():
    cfg = SyntheticTextConfig(vocab=100, seq=16, batch=4, seed=7)
    a = next(synthetic_lm_batches(cfg))
    b = next(synthetic_lm_batches(cfg))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 16)
    assert a["tokens"].dtype == a["labels"].dtype == np.int32
    # labels are next-token shifted
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 16, 4, 7),
                                                  (49152, 128, 8, 0),
                                                  (96, 64, 8, 3)])
def test_lm_batches_bitwise_equal_to_reference(vocab, seq, batch, seed):
    cfg = SyntheticTextConfig(vocab=vocab, seq=seq, batch=batch, seed=seed)
    jcfg = jsyn.SyntheticTextConfig(vocab=vocab, seq=seq, batch=batch,
                                    seed=seed)
    assert _zipf_probs(vocab).tobytes() == jsyn._zipf_probs(vocab).tobytes()
    for step in (0, 1, 12, 999):
        got, want = synthetic_lm_batch(cfg, step), \
            jsyn.synthetic_lm_batch(jcfg, step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for got, want in itertools.islice(zip(synthetic_lm_batches(cfg),
                                          jsyn.synthetic_lm_batches(jcfg)),
                                      3):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_lm_stream_has_planted_structure():
    cfg = SyntheticTextConfig(vocab=1000, seq=256, batch=8, seed=0)
    batch = next(synthetic_lm_batches(cfg))
    toks, labels = batch["tokens"], batch["labels"]
    follow = (toks * 7 + 3) % cfg.vocab
    frac = float(np.mean(labels == follow))
    # ~26% of transitions follow the planted bigram (consecutive rewrites
    # break some chains); chance level is 1/vocab = 0.1%.
    assert frac > 0.2                      # learnable bigram structure


def test_digits_and_textures():
    imgs, labels = synthetic_digits(64, seed=0)
    assert imgs.shape == (64, 28, 28, 1)
    assert imgs.min() >= 0 and imgs.max() <= 1
    assert set(np.unique(labels)).issubset(set(range(10)))
    m1, m8 = imgs[labels == 1].mean(0), imgs[labels == 8].mean(0)
    assert np.abs(m1 - m8).mean() > 0.02
    want = jsyn.synthetic_digits(64, seed=0)
    np.testing.assert_array_equal(imgs, want[0])
    np.testing.assert_array_equal(labels, want[1])
    imgs, labels = synthetic_textures(32, n_classes=10, seed=1)
    assert imgs.shape == (32, 32, 32, 3) and imgs.dtype == np.float32
    np.testing.assert_array_equal(imgs, jsyn.synthetic_textures(
        32, n_classes=10, seed=1)[0])


def test_modality_batch_per_arch():
    from repro_torch.configs import smoke_variant as tsmoke
    for arch in ("smollm-360m", "hubert-xlarge", "internvl2-26b"):
        cfg = tsmoke(arch)
        b = modality_batch(cfg, 2, 16, seed=0)
        assert "labels" in b
        if cfg.frontend == "audio":
            assert b["frames"].shape == (2, 16, cfg.frontend_dim)
        if cfg.frontend == "vision":
            assert b["patches"].shape == (2, cfg.n_patches, cfg.frontend_dim)
        want = jsyn.modality_batch(smoke_variant(arch), 2, 16, seed=0)
        assert b.keys() == want.keys()
        for k in b:
            np.testing.assert_array_equal(b[k], want[k])


def _batch_fn(step):
    return {"x": np.full((2,), step, np.float32)}


def test_pipeline_prefetch_order_and_determinism():
    p = DataPipeline(_batch_fn, prefetch=2, start_step=0)
    j = JDataPipeline(_batch_fn, prefetch=2, start_step=0)
    steps = []
    for _ in range(5):
        s, b = p.next()
        js, jb = j.next()
        steps.append(s)
        assert float(b["x"][0]) == s and isinstance(b["x"], np.ndarray)
        assert js == s and np.array_equal(jb["x"], b["x"])
    p.stop()
    j.stop()
    assert steps == [0, 1, 2, 3, 4]


def test_pipeline_resume_from_step():
    p = DataPipeline(lambda s: {"x": np.full((1,), s, np.float32)},
                     prefetch=1, start_step=10)
    s, b = p.next()
    p.stop()
    assert s == 10 and float(b["x"][0]) == 10.0


def test_pipeline_puts_tensors_on_the_device():
    p = DataPipeline(_batch_fn, device="cpu", prefetch=2, start_step=3)
    for want in (3, 4, 5):
        s, b = p.next()
        assert s == want and isinstance(b["x"], torch.Tensor)
        assert b["x"].device.type == "cpu"
        assert torch.equal(b["x"], torch.full((2,), want,
                                              dtype=torch.float32))
    p.stop()


def test_process_slice():
    sl = DataPipeline.process_slice(256, process_index=3, process_count=8)
    assert sl == slice(96, 128) == JDataPipeline.process_slice(
        256, process_index=3, process_count=8)
    assert DataPipeline.process_slice(256) == slice(0, 256)


def test_process_slice_reads_an_initialized_process_group(tmp_path):
    dist = torch.distributed
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert DataPipeline.process_slice(64) == slice(0, 64)
        assert DataPipeline.process_slice(64, process_count=4) == \
            slice(0, 16)
    finally:
        dist.destroy_process_group()
