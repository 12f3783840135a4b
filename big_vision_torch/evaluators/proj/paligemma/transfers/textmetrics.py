"""Host-side text metrics of the PaliGemma transfer evaluators: the port's
own copy of big_vision_tpu/evaluators/proj/paligemma/transfers/
textmetrics.py (pure Python, no package of metrics):
  * levenshtein / anls_metric: ANLS as in DocVQA (arXiv:1907.00490 Eq 1).
  * BLEU-4, ROUGE-L, CIDEr-D: the COCO captioning metrics
    (arXiv:1504.00325), with pycocoevalcap's formulas. Tokenization is a
    PTB-lite (lowercase, punctuation stripped): scores track the java
    PTBTokenizer's but are not bit-identical to them.
  * METEOR with the exact and Porter-stem modules (see `meteor`).
"""

from __future__ import annotations

import collections
import math
import re


def levenshtein(a: str, b: str) -> int:
  """Iterative two-row edit distance."""
  if len(a) < len(b):
    a, b = b, a
  if not b:
    return len(a)
  prev = list(range(len(b) + 1))
  for i, ca in enumerate(a, 1):
    cur = [i]
    for j, cb in enumerate(b, 1):
      cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                     prev[j - 1] + (ca != cb)))
    prev = cur
  return prev[-1]


def anls_metric(target: str, prediction: str, theta: float = 0.5):
  """Average Normalized Levenshtein Similarity (per-pair term)."""
  if target:
    nld = levenshtein(target, prediction) / max(len(target),
                                                len(prediction))
    return 1 - nld if nld < theta else 0
  return float(prediction == "")


_PUNCT_RE = re.compile(r"[^\w\s]")


def ptb_lite_tokenize(s: str) -> list[str]:
  """Lowercase, strip punctuation, split on whitespace."""
  return _PUNCT_RE.sub("", s.lower()).split()


def _ngrams(tokens, n):
  return collections.Counter(
      tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu4(gts: dict, res: dict) -> float:
  """Corpus-level BLEU-4 with closest-reference length penalty."""
  log_precisions = []
  for n in range(1, 5):
    match, total = 0, 0
    for iid, hyps in res.items():
      hyp = _ngrams(hyps[0], n)
      refs = [_ngrams(r, n) for r in gts[iid]]
      for gram, cnt in hyp.items():
        match += min(cnt, max((r[gram] for r in refs), default=0))
      total += sum(hyp.values())
    log_precisions.append(
        math.log(match / total) if match and total else -math.inf)
  hyp_len = sum(len(h[0]) for h in res.values())
  ref_len = sum(
      min((len(r) for r in gts[iid]),
          key=lambda l, h=len(res[iid][0]): (abs(l - h), l))
      for iid in res)
  bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
  score = bp * math.exp(sum(log_precisions) / 4)
  return 0.0 if math.isinf(score) or math.isnan(score) else score


def _lcs_len(a, b):
  if len(a) < len(b):
    a, b = b, a
  prev = [0] * (len(b) + 1)
  for ca in a:
    cur = [0]
    for j, cb in enumerate(b, 1):
      cur.append(prev[j - 1] + 1 if ca == cb else max(prev[j], cur[-1]))
    prev = cur
  return prev[-1]


def rouge_l(gts: dict, res: dict, beta: float = 1.2) -> float:
  """Mean over examples of max-over-references ROUGE-L F-measure."""
  scores = []
  for iid, hyps in res.items():
    hyp = hyps[0]
    best = 0.0
    for ref in gts[iid]:
      lcs = _lcs_len(hyp, ref)
      if lcs == 0 or not hyp or not ref:
        continue
      prec, rec = lcs / len(hyp), lcs / len(ref)
      best = max(best, ((1 + beta ** 2) * prec * rec)
                 / (rec + beta ** 2 * prec))
    scores.append(best)
  return sum(scores) / max(len(scores), 1)


def cider_d(gts: dict, res: dict, n_max: int = 4,
            sigma: float = 6.0) -> float:
  """CIDEr-D (arXiv:1411.5726): tf-idf n-gram cosine + length gaussian."""
  # Document frequencies over the reference corpus.
  dfs = [collections.Counter() for _ in range(n_max)]
  for refs in gts.values():
    for n in range(n_max):
      seen = set()
      for ref in refs:
        seen |= set(_ngrams(ref, n + 1))
      for g in seen:
        dfs[n][g] += 1
  log_num_imgs = math.log(max(len(gts), 1))

  def tfidf_vec(tokens, n):
    # RAW term frequency, like pycocoevalcap's cider_scorer counts2vec
    # (length-normalizing would change the clipped dot product whenever
    # hyp and ref lengths differ, since the clip compares across the two
    # differently-scaled vectors).
    counts = _ngrams(tokens, n + 1)
    vec, norm_sq = {}, 0.0
    for g, cnt in counts.items():
      idf = log_num_imgs - math.log(max(dfs[n][g], 1))
      w = cnt * idf
      vec[g] = w
      norm_sq += w * w
    return vec, math.sqrt(norm_sq)

  scores = []
  for iid, hyps in res.items():
    hyp = hyps[0]
    score_n = [0.0] * n_max
    for n in range(n_max):
      hv, hn = tfidf_vec(hyp, n)
      for ref in gts[iid]:
        rv, rn = tfidf_vec(ref, n)
        # Clipped dot product (the "-D" modification).
        dot = sum(min(w, rv.get(g, 0.0)) * rv.get(g, 0.0)
                  for g, w in hv.items())
        sim = dot / (hn * rn) if hn and rn else 0.0
        delta = len(hyp) - len(ref)
        sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
        score_n[n] += sim / len(gts[iid])
    scores.append(10.0 * sum(score_n) / n_max)
  return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# METEOR (native; exact + Porter-stem modules).
#
# pycocoevalcap scores METEOR with the java meteor-1.5 jar. This is a
# native implementation of the classic METEOR formulation (Banerjee &
# Lavie 2005):
#   Fmean = P*R / (alpha*P + (1-alpha)*R) with alpha=0.9 (recall-heavy),
#   Penalty = 0.5 * (chunks/matches)^3, score = Fmean * (1 - Penalty),
# with the exact (w=1.0) and Porter-stem (w=0.6) matcher modules. The
# jar's synonymy/paraphrase modules need WordNet/paraphrase tables and are
# omitted, and alignment here is greedy exact-then-stem in hypothesis
# order (the jar beam-searches chunk-minimal alignments) — absolute
# scores differ from meteor-1.5 by a point or two but rank the same.
# ---------------------------------------------------------------------------


def porter_stem(w):
  """Classic Porter (1980) stemmer, pure python."""
  if len(w) <= 2:
    return w
  w = w.lower()

  def cons(i):
    c = w[i]
    if c in "aeiou":
      return False
    if c == "y":
      return i == 0 or not cons(i - 1)
    return True

  def measure(stem):
    form = "".join("C" if _cons(stem, i) else "V"
                   for i in range(len(stem)))
    return form.replace("CC", "C").replace("VV", "V").count("VC")

  def _cons(s, i):
    c = s[i]
    if c in "aeiou":
      return False
    if c == "y":
      return i == 0 or not _cons(s, i - 1)
    return True

  def has_vowel(stem):
    return any(not _cons(stem, i) for i in range(len(stem)))

  def ends_cvc(s):
    return (len(s) >= 3 and _cons(s, -3 + len(s)) and
            not _cons(s, len(s) - 2) and _cons(s, len(s) - 1)
            and s[-1] not in "wxy")

  # Step 1a
  for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
    if w.endswith(suf):
      w = w[:-len(suf)] + rep
      break
  # Step 1b
  flag = False
  if w.endswith("eed"):
    if measure(w[:-3]) > 0:
      w = w[:-1]
  elif w.endswith("ed") and has_vowel(w[:-2]):
    w, flag = w[:-2], True
  elif w.endswith("ing") and has_vowel(w[:-3]):
    w, flag = w[:-3], True
  if flag:
    if w.endswith(("at", "bl", "iz")):
      w += "e"
    elif (len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)
          and w[-1] not in "lsz"):
      w = w[:-1]
    elif measure(w) == 1 and ends_cvc(w):
      w += "e"
  # Step 1c
  if w.endswith("y") and has_vowel(w[:-1]):
    w = w[:-1] + "i"
  # Step 2
  for suf, rep in (
      ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
      ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
      ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
      ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
      ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
      ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
      ("biliti", "ble")):
    if w.endswith(suf):
      if measure(w[:-len(suf)]) > 0:
        w = w[:-len(suf)] + rep
      break
  # Step 3
  for suf, rep in (
      ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
      ("ical", "ic"), ("ful", ""), ("ness", "")):
    if w.endswith(suf):
      if measure(w[:-len(suf)]) > 0:
        w = w[:-len(suf)] + rep
      break
  # Step 4
  for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
              "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
              "ous", "ive", "ize"):
    if w.endswith(suf):
      stem = w[:-len(suf)]
      if measure(stem) > 1 and (suf != "ion" or
                                (stem and stem[-1] in "st")):
        w = stem
      break
  # Step 5a
  if w.endswith("e"):
    stem = w[:-1]
    if measure(stem) > 1 or (measure(stem) == 1 and not ends_cvc(stem)):
      w = stem
  # Step 5b
  if (len(w) >= 2 and w[-1] == "l" and w[-2] == "l" and measure(w) > 1):
    w = w[:-1]
  return w


def _meteor_align(hyp, ref):
  """Greedy exact-then-stem alignment; returns (weighted_m, m, chunks)."""
  ref_used = [False] * len(ref)
  align = [None] * len(hyp)  # hyp idx -> (ref idx, module weight)
  for module, weight in ((lambda x: x, 1.0), (porter_stem, 0.6)):
    ref_keys = [module(r) for r in ref]
    for i, h in enumerate(hyp):
      if align[i] is not None:
        continue
      hk = module(h)
      for j, rk in enumerate(ref_keys):
        if not ref_used[j] and hk == rk:
          align[i] = (j, weight)
          ref_used[j] = True
          break
  pairs = [(i, a[0]) for i, a in enumerate(align) if a is not None]
  m = len(pairs)
  wm = sum(a[1] for a in align if a is not None)
  chunks = 0
  for idx, (i, j) in enumerate(pairs):
    if idx == 0 or pairs[idx - 1] != (i - 1, j - 1):
      chunks += 1
  return wm, m, chunks


def meteor(gts: dict, res: dict, alpha=0.9, beta=3.0, gamma=0.5) -> float:
  """Mean best-reference METEOR over images; tokens in, like bleu4."""
  total = 0.0
  for iid, hyps in res.items():
    hyp = hyps[0]
    best = 0.0
    for ref in gts[iid]:
      wm, m, chunks = _meteor_align(hyp, ref)
      if m == 0 or not hyp or not ref:
        continue
      p = wm / len(hyp)
      r = wm / len(ref)
      if p + r == 0:
        continue
      fmean = p * r / (alpha * p + (1 - alpha) * r)
      frag = chunks / m if m else 0.0
      score = fmean * (1.0 - gamma * frag ** beta)
      best = max(best, score)
    total += best
  return total / max(len(res), 1)
