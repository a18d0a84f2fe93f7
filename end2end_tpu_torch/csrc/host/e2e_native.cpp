// Native host-side runtime for end2end_tpu.
//
// The TPU compute path is JAX/Pallas; this library covers the host-side jobs
// the reference did in C++ (SURVEY.md §3.1): a threaded CPU prefix
// beam-search decoder (N3 + its thread pool N4 — used as a fast host
// fallback and as an independent oracle for the TPU decoder), a greedy
// decoder (N2), and a KenLM-style ARPA n-gram parser (N6) that materializes
// dense unigram/bigram tables for device-side shallow fusion (ops/lm.py).
//
// Exposed as a plain C ABI consumed via ctypes (utils/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();

inline float logaddexp(float a, float b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  float m = std::max(a, b);
  return m + std::log1p(std::exp(-std::fabs(a - b)));
}

struct Hyp {
  float pb;   // log prob of prefix ending in blank
  float pnb;  // log prob of prefix ending in non-blank
  float lm;   // accumulated alpha*lm + beta shallow-fusion bonus
};

// Prefix beam search for one utterance.  lp: (T, V) row-major log-probs.
// Optional dense-bigram shallow fusion (the reference's KenLM hook): lm_t is
// (V+1, V) row-major log p(next | prev) with row V = start-of-sequence
// context, lm_e (V) the end-of-sequence scores; candidates are RANKED with
// the accumulated alpha*lm + beta bonus and the </s> score is added at the
// end — identical semantics to the JAX decoders (ops/beam_search.py).
void beam_search_one(const float* lp, int t_len, int v, int w, int k,
                     int blank, int s_cap, const float* lm_t,
                     const float* lm_e, float alpha, float beta,
                     int* out_tokens, int* out_lens, float* out_scores) {
  using Prefix = std::vector<int32_t>;
  struct VecHash {
    size_t operator()(const Prefix& p) const {
      size_t h = 1469598103934665603ull;
      for (int32_t c : p) {
        h ^= static_cast<size_t>(c) + 0x9e3779b9ull;
        h *= 1099511628211ull;
      }
      return h;
    }
  };
  std::unordered_map<Prefix, Hyp, VecHash> beams;
  beams[{}] = {0.0f, kNegInf, 0.0f};
  std::vector<int> cand(v);
  for (int t = 0; t < t_len; ++t) {
    const float* row = lp + static_cast<size_t>(t) * v;
    int kk = std::min(k, v);
    for (int i = 0; i < v; ++i) cand[i] = i;
    if (kk < v) {
      std::partial_sort(cand.begin(), cand.begin() + kk, cand.end(),
                        [&](int a, int b) { return row[a] > row[b]; });
    }
    std::unordered_map<Prefix, Hyp, VecHash> next;
    next.reserve(beams.size() * (kk + 1));
    // lm is a pure function of the prefix, so on merges it is identical —
    // try_emplace keeps the first copy
    auto add = [&next](const Prefix& p, float pb, float pnb, float lm) {
      auto it = next.try_emplace(p, Hyp{kNegInf, kNegInf, lm}).first;
      it->second.pb = logaddexp(it->second.pb, pb);
      it->second.pnb = logaddexp(it->second.pnb, pnb);
    };
    for (const auto& [prefix, hyp] : beams) {
      float total = logaddexp(hyp.pb, hyp.pnb);
      // blank: prefix unchanged, ends in blank
      add(prefix, total + row[blank], kNegInf, hyp.lm);
      // repeat last char without separator
      if (!prefix.empty())
        add(prefix, kNegInf, hyp.pnb + row[prefix.back()], hyp.lm);
      int ctx = prefix.empty() ? v : prefix.back();  // row v = <s>
      Prefix ext = prefix;
      ext.push_back(0);
      for (int i = 0; i < kk; ++i) {
        int c = cand[i];
        if (c == blank) continue;
        if (static_cast<int>(prefix.size()) >= s_cap) continue;
        ext.back() = c;
        float lm_child = hyp.lm;
        if (lm_t)
          lm_child += alpha * lm_t[static_cast<size_t>(ctx) * v + c] + beta;
        if (!prefix.empty() && c == prefix.back()) {
          add(ext, kNegInf, hyp.pb + row[c], lm_child);
        } else {
          add(ext, kNegInf, total + row[c], lm_child);
        }
      }
    }
    // prune to top-w, ranking WITH the LM bonus (like the device decoders)
    std::vector<std::pair<float, const Prefix*>> scored;
    scored.reserve(next.size());
    for (const auto& [p, h] : next)
      scored.emplace_back(logaddexp(h.pb, h.pnb) + h.lm, &p);
    int keep = std::min<int>(w, scored.size());
    std::partial_sort(
        scored.begin(), scored.begin() + keep, scored.end(),
        [](const auto& a, const auto& b) { return a.first > b.first; });
    std::unordered_map<Prefix, Hyp, VecHash> pruned;
    pruned.reserve(keep);
    for (int i = 0; i < keep; ++i) pruned.emplace(*scored[i].second, next[*scored[i].second]);
    beams.swap(pruned);
  }
  std::vector<std::pair<float, const Prefix*>> fin;
  fin.reserve(beams.size());
  for (const auto& [p, h] : beams) {
    float sc = logaddexp(h.pb, h.pnb) + h.lm;
    if (lm_e && !p.empty()) sc += alpha * lm_e[p.back()];
    fin.emplace_back(sc, &p);
  }
  std::sort(fin.begin(), fin.end(),
            [](const auto& a, const auto& b) { return a.first > b.first; });
  for (int i = 0; i < w; ++i) {
    int* tok = out_tokens + static_cast<size_t>(i) * s_cap;
    std::fill(tok, tok + s_cap, -1);
    if (i < static_cast<int>(fin.size())) {
      const Prefix& p = *fin[i].second;
      std::copy(p.begin(), p.end(), tok);
      out_lens[i] = static_cast<int>(p.size());
      out_scores[i] = fin[i].first;
    } else {
      out_lens[i] = 0;
      out_scores[i] = kNegInf;
    }
  }
}

}  // namespace

extern "C" {

// lp: (N, T, V) row-major; lengths: (N,).  Outputs: tokens (N, W, s_cap),
// lens (N, W), scores (N, W).  n_threads <= 0 -> hardware concurrency.
void e2e_beam_search(const float* lp, int n, int t_max, int v,
                     const int* lengths, int w, int k, int blank, int s_cap,
                     int32_t* out_tokens, int32_t* out_lens, float* out_scores,
                     int n_threads) {
  if (n_threads <= 0) n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, n);
  std::atomic<int> next_item{0};
  auto worker = [&]() {
    for (;;) {
      int b = next_item.fetch_add(1);
      if (b >= n) return;
      beam_search_one(lp + static_cast<size_t>(b) * t_max * v, lengths[b], v,
                      w, k, blank, s_cap, nullptr, nullptr, 0.0f, 0.0f,
                      out_tokens + static_cast<size_t>(b) * w * s_cap,
                      out_lens + static_cast<size_t>(b) * w,
                      out_scores + static_cast<size_t>(b) * w);
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < n_threads; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

// Beam search with dense-bigram shallow fusion.  lm_table: (V+1, V)
// row-major (row V = start context); lm_eos: (V).
void e2e_beam_search_lm(const float* lp, int n, int t_max, int v,
                        const int* lengths, int w, int k, int blank,
                        int s_cap, const float* lm_table, const float* lm_eos,
                        float alpha, float beta, int32_t* out_tokens,
                        int32_t* out_lens, float* out_scores, int n_threads) {
  if (n_threads <= 0) n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, n);
  std::atomic<int> next_item{0};
  auto worker = [&]() {
    for (;;) {
      int b = next_item.fetch_add(1);
      if (b >= n) return;
      beam_search_one(lp + static_cast<size_t>(b) * t_max * v, lengths[b], v,
                      w, k, blank, s_cap, lm_table, lm_eos, alpha, beta,
                      out_tokens + static_cast<size_t>(b) * w * s_cap,
                      out_lens + static_cast<size_t>(b) * w,
                      out_scores + static_cast<size_t>(b) * w);
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < n_threads; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

// Greedy decode: argmax -> collapse repeats -> strip blank.
void e2e_greedy_decode(const float* lp, int n, int t_max, int v,
                       const int* lengths, int blank, int32_t* out_tokens,
                       int32_t* out_lens) {
  for (int b = 0; b < n; ++b) {
    const float* base = lp + static_cast<size_t>(b) * t_max * v;
    int32_t* tok = out_tokens + static_cast<size_t>(b) * t_max;
    std::fill(tok, tok + t_max, -1);
    int prev = -1, m = 0;
    for (int t = 0; t < lengths[b]; ++t) {
      const float* row = base + static_cast<size_t>(t) * v;
      int best = static_cast<int>(std::max_element(row, row + v) - row);
      if (best != blank && best != prev) tok[m++] = best;
      prev = best;
    }
    out_lens[b] = m;
  }
}

// ARPA n-gram parser -> dense tables for ops/lm.NGramLM.
//
// vocab: `n_words` null-terminated strings, concatenated.  Outputs (natural
// log): unigram (V), backoff (V), bigram (V, V) filled with the backoff rule
// p(w2|w1) = p(w2) * bo(w1) where no explicit bigram exists; start (V) from
// "<s> w" bigrams; eos (V) from "w </s>" bigrams.  Words missing from the
// ARPA file get the <unk> unigram (or -1e30 without <unk>).  Returns the
// number of n-gram entries consumed, or -1 on I/O error.
long e2e_parse_arpa(const char* path, const char* vocab, int n_words,
                    float* unigram, float* bigram, float* start, float* eos) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  std::unordered_map<std::string, int> word_id;
  {
    const char* p = vocab;
    for (int i = 0; i < n_words; ++i) {
      word_id.emplace(p, i);
      p += std::strlen(p) + 1;
    }
  }
  const float ln10 = 2.302585092994046f;
  const float kLog0 = -1e30f;
  std::vector<float> uni(n_words, kLog0), bo(n_words, 0.0f);
  std::fill(start, start + n_words, kLog0);
  std::fill(eos, eos + n_words, kLog0);
  struct Bigram { int w1, w2; float lp; };
  std::vector<Bigram> bigrams;
  float unk_lp = kLog0, start_bo = 0.0f, eos_uni = kLog0;
  bool have_eos_uni = false;
  char line[4096];
  int section = 0;  // 1 = \1-grams:, 2 = \2-grams:
  long count = 0;
  while (std::fgets(line, sizeof line, f)) {
    if (std::strstr(line, "\\1-grams:")) { section = 1; continue; }
    if (std::strstr(line, "\\2-grams:")) { section = 2; continue; }
    if (std::strstr(line, "\\end\\") || std::strstr(line, "\\3-grams:")) { section = 3; continue; }
    if (section == 1) {
      char w[1024];
      float lp, b = 0.0f;
      int got = std::sscanf(line, "%f %1023s %f", &lp, w, &b);
      if (got < 2) continue;
      ++count;
      std::string ws(w);
      if (ws == "<unk>" || ws == "<UNK>") { unk_lp = lp * ln10; continue; }
      if (ws == "<s>") { start_bo = b * ln10; continue; }
      if (ws == "</s>") { eos_uni = lp * ln10; have_eos_uni = true; continue; }
      auto it = word_id.find(ws);
      if (it == word_id.end()) continue;
      uni[it->second] = lp * ln10;
      bo[it->second] = b * ln10;
    } else if (section == 2) {
      char w1[1024], w2[1024];
      float lp;
      if (std::sscanf(line, "%f %1023s %1023s", &lp, w1, w2) != 3) continue;
      ++count;
      std::string s1(w1), s2(w2);
      if (s2 == "</s>") {
        auto i1 = word_id.find(s1);
        if (i1 != word_id.end()) eos[i1->second] = lp * ln10;
        continue;
      }
      auto i2 = word_id.find(s2);
      if (i2 == word_id.end()) continue;
      if (s1 == "<s>") {
        start[i2->second] = lp * ln10;
        continue;
      }
      auto i1 = word_id.find(s1);
      if (i1 == word_id.end()) continue;
      bigrams.push_back({i1->second, i2->second, lp * ln10});
    }
  }
  std::fclose(f);
  for (int i = 0; i < n_words; ++i)
    if (uni[i] <= kLog0) uni[i] = unk_lp;
  // Dense fill with backoff, then overwrite explicit bigrams.
  for (int w1 = 0; w1 < n_words; ++w1) {
    float b = bo[w1];
    float* row = bigram + static_cast<size_t>(w1) * n_words;
    for (int w2 = 0; w2 < n_words; ++w2) row[w2] = b + uni[w2];
  }
  for (const auto& bg : bigrams)
    bigram[static_cast<size_t>(bg.w1) * n_words + bg.w2] = bg.lp;
  for (int w2 = 0; w2 < n_words; ++w2) {
    if (start[w2] <= kLog0) start[w2] = start_bo + uni[w2];
    // Unseen "w </s>" backs off to bo(w) + p(</s>); neutral without </s>.
    if (eos[w2] <= kLog0) eos[w2] = have_eos_uni ? bo[w2] + eos_uni : 0.0f;
    unigram[w2] = uni[w2];
  }
  return count;
}

// Generic-order ARPA parser (KenLM parity): flat n-gram dumps per order.
//
// Word ids are vocab indices; <s> = n_words, </s> = n_words + 1; grams
// containing <unk> or OOV words are skipped (the <unk> unigram log-prob is
// reported via *unk_logp, natural log; left untouched if absent).
//
// Two-call protocol:
//   e2e_arpa_scan(path, vocab, n_words, counts[9], unk_logp) -> max order
//     counts[k] = number of RETAINED k-grams (k = 1..8).
//   e2e_arpa_dump(path, vocab, n_words, k, ids (cap, k), lp (cap,),
//                 bo (cap,), cap) -> number written (-1 on I/O error).
static bool arpa_tokenize(char* line, int& section, char** words, int max_w,
                          int& n_tok, float& lp, float& bo) {
  // returns true when the line is an n-gram entry of the current section
  char* p = line;
  while (*p == ' ' || *p == '\t') ++p;
  if (*p == '\\') {
    int k = 0;
    if (std::sscanf(p, "\\%d-grams:", &k) == 1) section = k;
    else if (std::strncmp(p, "\\end\\", 5) == 0) section = -1;
    return false;
  }
  if (section < 1) return false;
  char* end;
  lp = std::strtof(p, &end);
  if (end == p) return false;
  p = end;
  n_tok = 0;
  for (int i = 0; i < section && n_tok < max_w; ++i) {
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == '\0' || *p == '\n' || *p == '\r') return false;
    words[n_tok++] = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
    if (*p) *p++ = '\0';
  }
  if (n_tok != section) return false;
  while (*p == ' ' || *p == '\t') ++p;
  bo = 0.0f;
  if (*p && *p != '\n' && *p != '\r') bo = std::strtof(p, nullptr);
  return true;
}

static void arpa_vocab_map(const char* vocab, int n_words,
                           std::unordered_map<std::string, int>& word_id) {
  const char* p = vocab;
  for (int i = 0; i < n_words; ++i) {
    word_id.emplace(p, i);
    p += std::strlen(p) + 1;
  }
  word_id.emplace("<s>", n_words);
  word_id.emplace("</s>", n_words + 1);
}

int e2e_arpa_scan(const char* path, const char* vocab, int n_words,
                  long* counts, float* unk_logp) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  std::unordered_map<std::string, int> word_id;
  arpa_vocab_map(vocab, n_words, word_id);
  const float ln10 = 2.302585092994046f;
  for (int k = 0; k < 9; ++k) counts[k] = 0;
  char line[8192];
  char* words[8];
  int section = 0, max_order = 0;
  while (std::fgets(line, sizeof line, f)) {
    int n_tok;
    float lp, bo;
    if (!arpa_tokenize(line, section, words, 8, n_tok, lp, bo)) {
      if (section == -1) break;
      if (section > 8) {  // beyond this parser's cap: refuse loudly so the
        std::fclose(f);   // caller falls back to the generic Python parser
        return -2;        // instead of silently truncating the model
      }
      continue;
    }
    if (section > max_order) max_order = section;
    if (section == 1 && (std::strcmp(words[0], "<unk>") == 0 ||
                         std::strcmp(words[0], "<UNK>") == 0)) {
      *unk_logp = lp * ln10;
      continue;
    }
    bool ok = true;
    for (int i = 0; i < n_tok; ++i)
      if (word_id.find(words[i]) == word_id.end()) { ok = false; break; }
    if (ok && section >= 1 && section <= 8) ++counts[section];
  }
  std::fclose(f);
  return max_order;
}

long e2e_arpa_dump(const char* path, const char* vocab, int n_words, int k,
                   int32_t* ids, float* lp_out, float* bo_out, long cap) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  std::unordered_map<std::string, int> word_id;
  arpa_vocab_map(vocab, n_words, word_id);
  const float ln10 = 2.302585092994046f;
  char line[8192];
  char* words[8];
  int section = 0;
  long n_out = 0;
  while (std::fgets(line, sizeof line, f) && n_out < cap) {
    int n_tok;
    float lp, bo;
    if (!arpa_tokenize(line, section, words, 8, n_tok, lp, bo)) {
      if (section == -1) break;
      continue;
    }
    if (section != k) continue;
    if (k == 1 && (std::strcmp(words[0], "<unk>") == 0 ||
                   std::strcmp(words[0], "<UNK>") == 0)) continue;
    bool ok = true;
    int tmp[8];
    for (int i = 0; i < n_tok; ++i) {
      auto it = word_id.find(words[i]);
      if (it == word_id.end()) { ok = false; break; }
      tmp[i] = it->second;
    }
    if (!ok) continue;
    for (int i = 0; i < k; ++i) ids[n_out * k + i] = tmp[i];
    lp_out[n_out] = lp * ln10;
    bo_out[n_out] = bo * ln10;
    ++n_out;
  }
  std::fclose(f);
  return n_out;
}

}  // extern "C"
