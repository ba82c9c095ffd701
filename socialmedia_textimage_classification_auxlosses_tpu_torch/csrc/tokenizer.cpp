// Native host-side tokenization for the PyTorch port.
//
// The port's own copy of the JAX package's csrc/tokenizer.cpp, bound with
// ctypes by data/native.py and compiled there at first use:
//   g++ -O3 -shared -fPIC -std=c++17 tokenizer.cpp -o libsmtc_tokenizer.so
// It holds the encoders the port calls, with the ids of its Python paths:
//   * the FNV-1a hashing tokenizer (data/tokenizers.py HashTokenizer);
//   * SentencePiece-BPE's merge loop (Bernice / XLM-R): the ModelProto is read
//     in Python (data/bpe_backends.py) and the pieces and scores arrive as
//     flat arrays; semantics as SentencePieceBPE._bpe;
//   * fastBPE (BERTweet) over a fairseq vocab.txt and bpe.codes; semantics as
//     FastBPE._bpe, the single-character quirk included;
//   * the JAX copy's greedy WordPiece (wp_*), which the JAX package reaches
//     only for a vocab.txt that its Rust BertWordPieceTokenizer refuses (no
//     [CLS] or no [SEP]): ASCII-only lowercasing, a split at the whitespace of
//     ws_len and at ASCII punctuation, words measured in bytes, missing
//     specials taken as [UNK] 100, [CLS] 101, [SEP] 102, [PAD] 0 (its Python
//     twin: data/native.py NativeWordPiece).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <fstream>
#include <cctype>
#include <limits>

// Byte length of a Unicode whitespace character starting at p (0 if none) —
// the same code-point set CPython's str.split()/str.strip() treat as
// whitespace, so native and Python tokenizer frontends split identically
// (U+00A0, U+2000.., U+3000 etc., not just ASCII isspace).
static size_t ws_len(const char* p, const char* end) {
  unsigned char c0 = (unsigned char)*p;
  if (c0 < 0x80) {
    return (c0 == ' ' || (c0 >= 0x09 && c0 <= 0x0d) ||
            (c0 >= 0x1c && c0 <= 0x1f)) ? 1 : 0;
  }
  if ((c0 & 0xE0) == 0xC0 && p + 1 < end) {
    uint32_t cp = ((uint32_t)(c0 & 0x1F) << 6) |
                  ((unsigned char)p[1] & 0x3F);
    return (cp == 0x85 || cp == 0xA0) ? 2 : 0;
  }
  if ((c0 & 0xF0) == 0xE0 && p + 2 < end) {
    uint32_t cp = ((uint32_t)(c0 & 0x0F) << 12) |
                  (((uint32_t)((unsigned char)p[1]) & 0x3F) << 6) |
                  ((unsigned char)p[2] & 0x3F);
    if (cp == 0x1680 || (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 ||
        cp == 0x2029 || cp == 0x202F || cp == 0x205F || cp == 0x3000)
      return 3;
    return 0;
  }
  return 0;
}

// Trim Unicode whitespace from both ends (CPython str.strip() semantics).
static void strip_ws(std::string& s) {
  const char* b = s.data();
  const char* e = s.data() + s.size();
  while (b < e) {
    size_t w = ws_len(b, e);
    if (!w) break;
    b += w;
  }
  // scan forward remembering the last non-whitespace end
  const char* last_end = b;
  const char* p = b;
  while (p < e) {
    size_t w = ws_len(p, e);
    if (w) { p += w; } else { ++p; last_end = p; }
  }
  s.assign(b, (size_t)(last_end - b));
}

// Split a UTF-8 string into code-point-sized chunks (invalid bytes pass
// through as single-byte chunks — matches Python's per-character split of
// already-decoded text).
static void utf8_split(const char* s, size_t n, std::vector<std::string>& out) {
  out.clear();
  size_t i = 0;
  while (i < n) {
    unsigned char c = (unsigned char)s[i];
    size_t len = 1;
    if ((c & 0x80) == 0x00) len = 1;
    else if ((c & 0xE0) == 0xC0) len = 2;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xF8) == 0xF0) len = 4;
    if (i + len > n) len = 1;
    out.emplace_back(s + i, len);
    i += len;
  }
}

extern "C" {

// ---------------------------------------------------------------------------
// FNV-1a hashing tokenizer
// ---------------------------------------------------------------------------

static inline uint32_t fnv1a(const char* s, size_t n) {
  uint32_t h = 2166136261u;
  for (size_t i = 0; i < n; ++i) {
    h ^= (uint8_t)s[i];
    h *= 16777619u;
  }
  return h;
}

// texts: concatenated UTF-8 buffer; offsets[n+1] delimit each text.
// out_ids/out_mask: (n, max_len) int32, caller-allocated.
void hash_encode_batch(const char* buf, const int64_t* offsets, int64_t n,
                       int32_t max_len, int32_t vocab_size, int32_t pad_id,
                       int32_t cls_id, int32_t sep_id, int32_t* out_ids,
                       int32_t* out_mask) {
  for (int64_t i = 0; i < n; ++i) {
    const char* s = buf + offsets[i];
    const char* end = buf + offsets[i + 1];
    int32_t* ids = out_ids + i * max_len;
    int32_t* mask = out_mask + i * max_len;
    for (int32_t j = 0; j < max_len; ++j) { ids[j] = pad_id; mask[j] = 0; }
    int32_t pos = 0;
    ids[pos] = cls_id; mask[pos] = 1; ++pos;
    const char* tok = s;
    while (tok < end && pos < max_len - 1) {
      while (tok < end) {
        size_t w = ws_len(tok, end);
        if (!w) break;
        tok += w;
      }
      const char* tstart = tok;
      while (tok < end && !ws_len(tok, end)) ++tok;
      if (tok > tstart) {
        uint32_t h = fnv1a(tstart, (size_t)(tok - tstart));
        ids[pos] = 4 + (int32_t)(h % (uint32_t)(vocab_size - 4));
        mask[pos] = 1;
        ++pos;
      }
    }
    ids[pos] = sep_id; mask[pos] = 1;
  }
}

// ---------------------------------------------------------------------------
// WordPiece
// ---------------------------------------------------------------------------

struct WordPiece {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk = 100, cls = 101, sep = 102, pad = 0;
  int32_t max_chars_per_word = 100;
};

void* wp_load(const char* vocab_path) {
  auto* wp = new WordPiece();
  std::ifstream in(vocab_path);
  if (!in) { delete wp; return nullptr; }
  std::string line;
  int32_t idx = 0;
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    wp->vocab.emplace(line, idx++);
  }
  auto get = [&](const char* t, int32_t dflt) {
    auto it = wp->vocab.find(t);
    return it == wp->vocab.end() ? dflt : it->second;
  };
  wp->unk = get("[UNK]", 100);
  wp->cls = get("[CLS]", 101);
  wp->sep = get("[SEP]", 102);
  wp->pad = get("[PAD]", 0);
  return wp;
}

void wp_free(void* handle) { delete (WordPiece*)handle; }

static void wp_word(const WordPiece& wp, const std::string& word,
                    std::vector<int32_t>& out) {
  if ((int32_t)word.size() > wp.max_chars_per_word) { out.push_back(wp.unk); return; }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = wp.vocab.find(sub);
      if (it != wp.vocab.end()) { cur = it->second; break; }
      --end;
    }
    if (cur < 0) { out.push_back(wp.unk); return; }
    pieces.push_back(cur);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

// Basic tokenization (lowercase, split on space + punctuation) then WordPiece.
void wp_encode_batch(void* handle, const char* buf, const int64_t* offsets,
                     int64_t n, int32_t max_len, int32_t* out_ids,
                     int32_t* out_mask, int32_t* out_type_ids) {
  const WordPiece& wp = *(WordPiece*)handle;
  std::vector<int32_t> toks;
  std::string word;
  for (int64_t i = 0; i < n; ++i) {
    const char* s = buf + offsets[i];
    const char* end = buf + offsets[i + 1];
    toks.clear();
    word.clear();
    auto flush = [&]() {
      if (!word.empty()) { wp_word(wp, word, toks); word.clear(); }
    };
    for (const char* c = s; c < end; ++c) {
      unsigned char ch = (unsigned char)*c;
      size_t w = ws_len(c, end);
      if (w) { flush(); c += w - 1; }
      else if (ch < 128 && std::ispunct(ch)) {
        flush();
        word.assign(1, (char)ch);
        flush();
      } else {
        word.push_back(ch < 128 ? (char)std::tolower(ch) : (char)ch);
      }
    }
    flush();
    int32_t* ids = out_ids + i * max_len;
    int32_t* mask = out_mask + i * max_len;
    int32_t* tts = out_type_ids ? out_type_ids + i * max_len : nullptr;
    for (int32_t j = 0; j < max_len; ++j) {
      ids[j] = wp.pad; mask[j] = 0;
      if (tts) tts[j] = 0;
    }
    int32_t pos = 0;
    ids[pos] = wp.cls; mask[pos] = 1; ++pos;
    for (size_t t = 0; t < toks.size() && pos < max_len - 1; ++t) {
      ids[pos] = toks[t]; mask[pos] = 1; ++pos;
    }
    ids[pos] = wp.sep; mask[pos] = 1;
  }
}

// ---------------------------------------------------------------------------
// SentencePiece-BPE (Bernice / XLM-R): greedy highest-score adjacent merge.
// Mirrors data/bpe_backends.py SentencePieceBPE._bpe: best STRICTLY greater
// score wins, earliest index on ties.
// ---------------------------------------------------------------------------

struct SpBpe {
  std::unordered_map<std::string, float> scores;   // normal pieces only
  std::unordered_map<std::string, int32_t> sp_ids; // all pieces
  int32_t bos = 0, pad = 1, eos = 2, unk = 3, offset = 1;
};

void* spbpe_load(const char* pieces_buf, const int64_t* piece_offsets,
                 const float* piece_scores, const uint8_t* is_normal,
                 int64_t n_pieces) {
  auto* sp = new SpBpe();
  sp->sp_ids.reserve((size_t)n_pieces * 2);
  for (int64_t i = 0; i < n_pieces; ++i) {
    std::string piece(pieces_buf + piece_offsets[i],
                      (size_t)(piece_offsets[i + 1] - piece_offsets[i]));
    sp->sp_ids.emplace(piece, (int32_t)i);
    if (is_normal[i]) sp->scores.emplace(std::move(piece), piece_scores[i]);
  }
  return sp;
}

void spbpe_free(void* handle) { delete (SpBpe*)handle; }

// Texts arrive PRE-NORMALIZED with the "▁" word markers already applied
// (SentencePieceBPE._normalize + marker substitution stay Python-side; the
// O(n^2) merge loop is the hot part and runs here).
void spbpe_encode_batch(void* handle, const char* buf, const int64_t* offsets,
                        int64_t n, int32_t max_len, int32_t* out_ids,
                        int32_t* out_mask) {
  const SpBpe& sp = *(SpBpe*)handle;
  std::vector<std::string> symbols;
  for (int64_t i = 0; i < n; ++i) {
    const char* s = buf + offsets[i];
    size_t len = (size_t)(offsets[i + 1] - offsets[i]);
    utf8_split(s, len, symbols);
    // greedy merge: repeatedly fuse the adjacent pair with the highest score
    while (symbols.size() > 1) {
      float best_score = 0.f;
      bool have = false;
      size_t best_i = 0;
      for (size_t j = 0; j + 1 < symbols.size(); ++j) {
        auto it = sp.scores.find(symbols[j] + symbols[j + 1]);
        if (it != sp.scores.end() && (!have || it->second > best_score)) {
          best_score = it->second;
          best_i = j;
          have = true;
        }
      }
      if (!have) break;
      symbols[best_i] += symbols[best_i + 1];
      symbols.erase(symbols.begin() + best_i + 1);
    }
    int32_t* ids = out_ids + i * max_len;
    int32_t* mask = out_mask + i * max_len;
    for (int32_t j = 0; j < max_len; ++j) { ids[j] = sp.pad; mask[j] = 0; }
    int32_t pos = 0;
    ids[pos] = sp.bos; mask[pos] = 1; ++pos;
    if (len > 0) {
      for (size_t t = 0; t < symbols.size() && pos < max_len - 1; ++t) {
        auto it = sp.sp_ids.find(symbols[t]);
        int32_t id = (it == sp.sp_ids.end() || it->second == 0)
                         ? sp.unk : it->second + sp.offset;
        ids[pos] = id; mask[pos] = 1; ++pos;
      }
    }
    ids[pos] = sp.eos; mask[pos] = 1;
  }
}

// ---------------------------------------------------------------------------
// fastBPE (BERTweet): fairseq vocab.txt + bpe.codes, lowest-rank merges with
// </w> end-of-word markers and @@ continuation. Mirrors FastBPE._bpe.
// ---------------------------------------------------------------------------

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

struct FastBpe {
  std::unordered_map<std::string, int32_t> encoder;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      ranks;
  std::unordered_map<std::string, std::vector<std::string>> cache;
  int32_t bos = 0, pad = 1, eos = 2, unk = 3;
};

void* fastbpe_load(const char* vocab_path, const char* codes_path) {
  auto* fb = new FastBpe();
  fb->encoder = {{"<s>", 0}, {"<pad>", 1}, {"</s>", 2}, {"<unk>", 3}};
  std::ifstream vin(vocab_path);
  if (!vin) { delete fb; return nullptr; }
  std::string line;
  while (std::getline(vin, line)) {
    strip_ws(line);  // Python side does line.strip() (Unicode, both ends)
    if (line.empty()) continue;
    size_t idx = line.rfind(' ');
    if (idx == std::string::npos) { delete fb; return nullptr; }
    std::string tok = line.substr(0, idx);
    int32_t id = (int32_t)fb->encoder.size();
    fb->encoder.emplace(std::move(tok), id);
  }
  std::ifstream cin_(codes_path);
  if (!cin_) { delete fb; return nullptr; }
  int32_t rank = 0;
  while (std::getline(cin_, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty()) { ++rank; continue; }  // keep fairseq line-order ranks
    // "left right count" -> (left, right)
    size_t sp1 = line.find(' ');
    size_t sp2 = line.rfind(' ');
    if (sp1 == std::string::npos || sp2 <= sp1) { ++rank; continue; }
    fb->ranks.emplace(std::make_pair(line.substr(0, sp1),
                                     line.substr(sp1 + 1, sp2 - sp1 - 1)),
                      rank);
    ++rank;
  }
  return fb;
}

void fastbpe_free(void* handle) { delete (FastBpe*)handle; }

static const std::vector<std::string>& fb_word(FastBpe& fb,
                                               const std::string& token) {
  auto hit = fb.cache.find(token);
  if (hit != fb.cache.end()) return hit->second;
  std::vector<std::string> word;
  utf8_split(token.data(), token.size(), word);
  std::vector<std::string> result;
  if (word.size() <= 1) {
    // single-char quirk preserved (BertweetTokenizer.bpe): the raw token,
    // WITHOUT the </w> marker, is the output piece
    result.push_back(token);
    return fb.cache.emplace(token, std::move(result)).first->second;
  }
  word.back() += "</w>";
  const int32_t INF = std::numeric_limits<int32_t>::max();
  while (true) {
    // lowest-rank bigram present in the word
    int32_t best = INF;
    std::pair<std::string, std::string> bigram;
    for (size_t j = 0; j + 1 < word.size(); ++j) {
      auto it = fb.ranks.find(std::make_pair(word[j], word[j + 1]));
      if (it != fb.ranks.end() && it->second < best) {
        best = it->second;
        bigram = it->first;
      }
    }
    if (best == INF) break;
    // merge every (first, second) occurrence left-to-right
    std::vector<std::string> next;
    size_t i = 0;
    while (i < word.size()) {
      if (word[i] == bigram.first && i + 1 < word.size() &&
          word[i + 1] == bigram.second) {
        next.push_back(bigram.first + bigram.second);
        i += 2;
      } else {
        next.push_back(word[i]);
        ++i;
      }
    }
    word.swap(next);
    if (word.size() == 1) break;
  }
  // drop the trailing </w>; pieces before the last carry the @@ suffix
  for (size_t j = 0; j < word.size(); ++j) {
    std::string piece = word[j];
    if (j + 1 == word.size()) {
      if (piece.size() >= 4 &&
          piece.compare(piece.size() - 4, 4, "</w>") == 0)
        piece.resize(piece.size() - 4);
    } else {
      piece += "@@";
    }
    result.push_back(std::move(piece));
  }
  return fb.cache.emplace(token, std::move(result)).first->second;
}

void fastbpe_encode_batch(void* handle, const char* buf,
                          const int64_t* offsets, int64_t n, int32_t max_len,
                          int32_t* out_ids, int32_t* out_mask) {
  FastBpe& fb = *(FastBpe*)handle;
  for (int64_t i = 0; i < n; ++i) {
    const char* s = buf + offsets[i];
    const char* end = buf + offsets[i + 1];
    int32_t* ids = out_ids + i * max_len;
    int32_t* mask = out_mask + i * max_len;
    for (int32_t j = 0; j < max_len; ++j) { ids[j] = fb.pad; mask[j] = 0; }
    int32_t pos = 0;
    ids[pos] = fb.bos; mask[pos] = 1; ++pos;
    const char* tok = s;
    while (tok < end && pos < max_len - 1) {
      while (tok < end) {
        size_t w = ws_len(tok, end);
        if (!w) break;
        tok += w;
      }
      const char* tstart = tok;
      while (tok < end && !ws_len(tok, end)) ++tok;
      if (tok == tstart) break;
      std::string token(tstart, (size_t)(tok - tstart));
      const auto& pieces = fb_word(fb, token);
      for (const auto& p : pieces) {
        if (pos >= max_len - 1) break;
        auto it = fb.encoder.find(p);
        ids[pos] = (it == fb.encoder.end()) ? fb.unk : it->second;
        mask[pos] = 1;
        ++pos;
      }
    }
    ids[pos] = fb.eos; mask[pos] = 1;
  }
}

}  // extern "C"
