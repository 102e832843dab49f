"""The port's byte-level ``BPETokenizer`` against the JAX package's.

The algorithm is deterministic, so every check is equality: the merges
trained from a fixed text (the synthetic corpus at the chip run's vocab
size, 512, plus a tie-heavy text whose pair counts draw), the ids of a
text with unseen and multi-byte characters, the round trip, and the
merges file each package saves and the other loads.
"""

import numpy as np
import pytest

from rocket_tpu.data.text import BPETokenizer as JBPE
from rocket_tpu_torch.data.text import BPETokenizer, synthetic_corpus

TEXT = synthetic_corpus(100_000, seed=3) + " naïve café — 😀\ttabs\n\n  spaces "
TIES = "ab ab ba ba cd cd dc dc aaaa aaa bbbb abab " * 4


@pytest.mark.parametrize("text,vocab", [(TEXT, 512), (TIES, 300), (TEXT[:2000], 256)],
                         ids=["corpus-512", "ties-300", "no-merges"])
def test_merges_and_ids_equal_the_reference(text, vocab):
    ours, theirs = BPETokenizer.train(text, vocab), JBPE.train(text, vocab)
    assert ours.merges == theirs.merges
    assert ours.vocab == theirs.vocab and ours.vocab_size == theirs.vocab_size
    probe = text[:3000] + " unseen ñ ☃ \x00 end"
    np.testing.assert_array_equal(ours.encode(probe), theirs.encode(probe))
    assert ours.encode(probe).dtype == np.int32
    assert ours.decode(ours.encode(probe)) == probe


def test_the_corpus_trains_to_the_full_vocab_and_compresses():
    tok = BPETokenizer.train(TEXT, 512)
    assert tok.vocab_size == 512 and len(tok.merges) == 256
    assert len(tok.encode(TEXT)) < len(TEXT.encode("utf-8")) / 2
    with pytest.raises(ValueError):
        BPETokenizer.train(TEXT, 100)


def test_save_and_load_cross_the_packages(tmp_path):
    ours = BPETokenizer.train(TIES, 300)
    ours.save(str(tmp_path / "ours.json"))
    theirs = JBPE.load(str(tmp_path / "ours.json"))
    assert theirs.merges == ours.merges
    JBPE.train(TEXT, 400).save(str(tmp_path / "theirs.json"))
    back = BPETokenizer.load(str(tmp_path / "theirs.json"))
    assert back.merges == JBPE.train(TEXT, 400).merges
    JBPE(ours.merges).save(str(tmp_path / "same.json"))
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "same.json").read_text()
    np.testing.assert_array_equal(back.encode(TEXT[:500]), JBPE.train(TEXT, 400).encode(TEXT[:500]))
