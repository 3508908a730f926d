"""The port's data pipeline (a numpy-only copy) against the reference's:
batches, cursor state and eval streams byte-equal for each seed, DP rank
and resume point."""
import pytest

from repro.data import pipeline as J
from repro_torch.data import pipeline as T


def pipes(seed, *, rank=0, size=1, batch=3, seq=24, vocab=128):
    out = []
    for mod in (J, T):
        corpus = mod.SyntheticCorpus(mod.SyntheticCorpusConfig(
            vocab_size=vocab, doc_len_mean=40, seed=seed))
        out.append(mod.DataPipeline(corpus, batch=batch, seq=seq,
                                    dp_rank=rank, dp_size=size))
    return out


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed,rank,size", [(7, 0, 1), (1234, 0, 1),
                                            (3, 1, 4), (3, 3, 4)])
def test_batches_and_state_byte_equal(seed, rank, size):
    ref, port = pipes(seed, rank=rank, size=size)
    for _ in range(5):
        assert_batches_equal(ref.next_batch(), port.next_batch())
        assert ref.state() == port.state()


def test_resume_from_the_reference_state():
    ref, port = pipes(11)
    for _ in range(3):
        ref.next_batch()
    _, fresh = pipes(11)
    fresh.restore(ref.state())
    for _ in range(3):
        assert_batches_equal(ref.next_batch(), fresh.next_batch())
    assert ref.state() == fresh.state()


@pytest.mark.parametrize("seed", [5, 1234])
def test_eval_stream_byte_equal(seed):
    got = [T.make_eval_stream(T.SyntheticCorpus(T.SyntheticCorpusConfig(
        vocab_size=512, seed=seed)), batch=2, seq=16, n_batches=3)]
    want = [J.make_eval_stream(J.SyntheticCorpus(J.SyntheticCorpusConfig(
        vocab_size=512, seed=seed)), batch=2, seq=16, n_batches=3)]
    for a, b in zip(got[0], want[0]):
        assert_batches_equal(a, b)


def test_corpus_tables_equal():
    cfg = dict(vocab_size=300, branching=12, zipf_a=1.1, seed=9)
    a = T.SyntheticCorpus(T.SyntheticCorpusConfig(**cfg))
    b = J.SyntheticCorpus(J.SyntheticCorpusConfig(**cfg))
    assert a.succ.tobytes() == b.succ.tobytes()
    assert a.cum.tobytes() == b.cum.tobytes()
    for doc in (0, 17, 10_000_000):
        assert a.document(doc).tobytes() == b.document(doc).tobytes()
