// wordpiece.cpp — fast BERT-style WordPiece tokenizer (C++17).
//
// Host-side ingest hot path: documents are tokenized here before windowing
// and device embedding. The reference does this inside HF `tokenizers` (Rust,
// via rust-bert — SURVEY.md §2.2); this is a fresh implementation of the
// standard pipeline: basic tokenization (lowercase, accent strip,
// punctuation split, CJK isolation) + greedy longest-match WordPiece.
//
// UTF-8 aware; lowercase/accent-strip covers ASCII, Latin-1 and
// Latin Extended-A (the ranges that matter for MiniLM's uncased vocab).
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 1;
  size_t max_chars_per_word = 100;
};

// --- UTF-8 ------------------------------------------------------------------

inline uint32_t decode_utf8(const char* s, size_t len, size_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;
  return 0xFFFD;
}

inline void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) out += (char)cp;
  else if (cp < 0x800) {
    out += (char)(0xC0 | (cp >> 6));
    out += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += (char)(0xE0 | (cp >> 12));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  } else {
    out += (char)(0xF0 | (cp >> 18));
    out += (char)(0x80 | ((cp >> 12) & 0x3F));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  }
}

// --- character classes --------------------------------------------------------

inline bool is_space(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0x0B ||
         cp == 0x0C || cp == 0xA0 || cp == 0x2028 || cp == 0x2029 ||
         (cp >= 0x2000 && cp <= 0x200A) || cp == 0x3000;
}

inline bool is_control(uint32_t cp) {
  return (cp < 0x20 && !(cp == '\t' || cp == '\n' || cp == '\r')) ||
         (cp >= 0x7F && cp < 0xA0) || cp == 0xAD;
}

inline bool is_punct(uint32_t cp) {
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  // General punctuation, CJK symbols, fullwidth forms
  return (cp >= 0x2010 && cp <= 0x2027) || (cp >= 0x2030 && cp <= 0x205E) ||
         (cp >= 0x3001 && cp <= 0x303F) || (cp >= 0xFF01 && cp <= 0xFF0F) ||
         (cp >= 0xFF1A && cp <= 0xFF20) || (cp >= 0xFF3B && cp <= 0xFF40) ||
         (cp >= 0xFF5B && cp <= 0xFF65) || cp == 0xAB || cp == 0xBB ||
         cp == 0xA1 || cp == 0xBF;
}

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0xF900 && cp <= 0xFAFF);
}

// Lowercase + accent-strip for ASCII / Latin-1 / Latin Extended-A.
// Returns 0 to drop the char (combining mark); '*' entries keep the cp.
inline uint32_t normalize_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0x300 && cp <= 0x36F) return 0;  // combining diacritics
  if (cp >= 0xC0 && cp <= 0xFF) {
    // One char per codepoint 0xC0..0xFF ('*' = keep original, e.g. x and /).
    static const char kLatin1[65] =
        "aaaaaaaceeeeiiiidnooooo*ouuuuytsaaaaaaaceeeeiiiidnooooo*ouuuuyty";
    char m = kLatin1[cp - 0xC0];
    return m == '*' ? cp : (uint32_t)m;
  }
  if (cp >= 0x100 && cp <= 0x17F) {
    // One char per codepoint 0x100..0x17F (Latin Extended-A -> base letter).
    static const char kLatinExtA[129] =
        "aaaaaaccccccccddddeeeeeeeeeegggggggghhhhiiiiiiiiiiiijjkkk"
        "llllllllllnnnnnnnnnoooooooorrrrrrsssssssstttttt"
        "uuuuuuuuuuuuwwyyyzzzzzzs";
    return (uint32_t)kLatinExtA[cp - 0x100];
  }
  return cp;
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-joined tokens, ids = line order.
void* wp_new(const char* vocab_blob, uint64_t blob_len, int32_t unk_id) {
  auto* t = new Tokenizer();
  t->unk_id = unk_id;
  std::string tok;
  int32_t id = 0;
  for (uint64_t i = 0; i <= blob_len; ++i) {
    if (i == blob_len || vocab_blob[i] == '\n') {
      if (!tok.empty()) t->vocab.emplace(tok, id);
      id++;
      tok.clear();
    } else {
      tok += vocab_blob[i];
    }
  }
  return t;
}

void wp_free(void* h) { delete (Tokenizer*)h; }

// Tokenize UTF-8 `text` into up to `max_out` ids. Returns count (may exceed
// max_out to signal truncation need; only max_out ids are written).
int64_t wp_encode(void* h, const char* text, uint64_t text_len,
                  int32_t* out, int64_t max_out) {
  auto* t = (Tokenizer*)h;
  int64_t n = 0;
  auto emit = [&](int32_t id) {
    if (n < max_out) out[n] = id;
    n++;
  };
  auto wordpiece = [&](const std::string& word, const std::vector<size_t>& starts) {
    // starts: byte offsets of codepoint boundaries + terminal word.size()
    size_t ncp = starts.size() - 1;
    if (ncp > t->max_chars_per_word) { emit(t->unk_id); return; }
    size_t start_cp = 0;
    std::vector<int32_t> pieces;
    while (start_cp < ncp) {
      size_t end_cp = ncp;
      int32_t found = -1;
      while (start_cp < end_cp) {
        std::string sub = word.substr(starts[start_cp], starts[end_cp] - starts[start_cp]);
        if (start_cp > 0) sub = "##" + sub;
        auto it = t->vocab.find(sub);
        if (it != t->vocab.end()) { found = it->second; break; }
        end_cp--;
      }
      if (found < 0) { emit(t->unk_id); return; }
      pieces.push_back(found);
      start_cp = end_cp;
    }
    for (int32_t p : pieces) emit(p);
  };

  std::string word;
  std::vector<size_t> starts{0};
  auto flush = [&]() {
    if (!word.empty()) {
      wordpiece(word, starts);
      word.clear();
      starts.assign(1, 0);
    }
  };

  size_t i = 0;
  while (i < text_len) {
    uint32_t cp = decode_utf8(text, text_len, i);
    cp = normalize_cp(cp);
    if (cp == 0) continue;  // stripped combining mark
    if (is_space(cp) || is_control(cp)) { flush(); continue; }
    if (is_punct(cp) || is_cjk(cp)) {
      flush();
      std::string one;
      append_utf8(one, cp);
      std::vector<size_t> st{0, one.size()};
      wordpiece(one, st);
      continue;
    }
    append_utf8(word, cp);
    starts.push_back(word.size());
  }
  flush();
  return n;
}

}  // extern "C"
