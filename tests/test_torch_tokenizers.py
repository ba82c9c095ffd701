"""PyTorch port's hashing tokenizer + tweet normalizer against the JAX
package's (which may run its native C++ encoder): identical ids and masks on
tweet-like strings with emoji, URLs, @-mentions, hashtags and HTML."""

import numpy as np
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.data import tokenizers as JT
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import tokenizers as TT

TWEETS = [
    "I love this!!!! 😍😍 https://t.co/abc123 @someone",
    "@user1 @user2 check out #NewMusic http://example.com/x?y=1",
    "can't wait for the weekend 🎉🎉🎉",
    "RT @news: Breaking — markets fall 3% at 9:30 a.m. EST",
    "&amp; then &lt;3 happened... sooo goooood",
    "Call me at 555-123-4567 or mail me@example.org",
    "😂😂😂 this is too much lol",
    "Ça va? ¿Qué tal? Привет мир 你好",
    "",
    "   leading and trailing spaces   ",
    "#throwback to 2019 ❤️ #summer #beach",
    "wow :) :-( <3 :P",
    "The quick brown fox jumps over the lazy dog " * 12,
    "she said \"no way\" and left -> bye",
    "@USER HTTPURL already normalized",
    "emoji with skin tone 👍🏽 and flags 🇺🇸",
    "www.example.com is up, and so is t.co/xyz",
    "don't won't shouldn't y'all",
    "numbers 1,000,000 and 3.14159 and -42",
    "mixed CASE Words AND MoRe",
]


@pytest.mark.parametrize("model_name", ["bernice", "bert"])
def test_hash_tokenizer_matches_jax(model_name):
    vocab = 250002 if model_name == "bernice" else 30522
    jt = JT.build_tokenizer(model_name, None, 128, vocab)
    tt = TT.build_tokenizer(model_name, None, 128, vocab)
    je, te = jt(TWEETS), tt(TWEETS)
    assert set(je) == set(te)
    for key in je:
        np.testing.assert_array_equal(te[key], je[key], err_msg=key)
        assert te[key].dtype == np.int32


def test_normalized_text_matches_jax():
    from socialmedia_textimage_classification_auxlosses_tpu.data.normalize import (
        TweetNormalizer as JN,
    )
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.normalize import (
        TweetNormalizer as TN,
    )

    jn, tn = JN(), TN()
    assert [tn.normalize(s) for s in TWEETS] == [jn.normalize(s) for s in TWEETS]


def test_vocabulary_directory_is_refused(tmp_path):
    (tmp_path / "vocab.txt").write_text("[PAD]\n")
    with pytest.raises(NotImplementedError):
        TT.build_tokenizer("bert", str(tmp_path), 16, 30522)
