"""The CLIP ViT-B/32 text tower and its BPE tokenizer (counterpart of
``sph_nca_tpu/training/clip_text.py``).

  * ``CLIPTextEncoder``: 12 causal blocks of width 512 (8 heads, the image
    tower's ``_block`` with a ``-inf`` mask above the diagonal), the final
    LN, pooling at the EOT token (the highest id of a row), the projection
    to 512, L2-normalized. Vocabulary 49408, context 77.
  * ``SimpleTokenizer``: CLIP's byte-pair encoding over a merges file
    (``bpe_simple_vocab_16e6.txt.gz``, supplied by the user: nothing is
    downloaded). Its word splitter is written out over Unicode categories
    (letters L*, numbers N*, whitespace) instead of the ``regex`` package's
    ``\\p{L}`` / ``\\p{N}``, which the card's machine lacks; the pieces are
    the same. Without a merges file ``fallback_tokenize`` hashes the UTF-8
    bytes into the id space, as the JAX package does (not semantically
    CLIP: pair it with random weights).
  * ``convert_open_clip_text``: an open_clip text state dict -> the
    ``.npz`` (its block keys carry a ``t_`` prefix, so one file can hold
    both towers); ``load_text_encoder`` reads it.

The tokenizer is pure Python and numpy; the tower is plain PyTorch, as the
JAX package computes it in XLA.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from .clip_encoder import IMAGE_KEYS, _block, _block_arrays, _layernorm, \
    _tensors

VOCAB = 49408
CONTEXT = 77
T_WIDTH = 512
T_LAYERS = 12
T_HEADS = 8
EMBED = 512

SOT, EOT = "<start_of_text>", "<end_of_text>"
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


# ---- the tokenizer (CLIP's SimpleTokenizer) --------------------------------


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 / CLIP BPE)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    """The deterministic parts of open_clip's ftfy chain: a double HTML
    unescape, NFC normalization, control characters dropped (tabs and
    newlines kept), stripped."""
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    text = "".join(ch for ch in text
                   if unicodedata.category(ch) != "Cc" or ch in "\t\n")
    return text.strip()


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def split_words(text: str) -> List[str]:
    """The pieces CLIP's pattern ``<start_of_text>|<end_of_text>|'s|'t|'re|
    've|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` finds in ``text``
    (case-insensitively; ``encode`` lowercases first), scanned as
    ``findall`` scans: at each position the first alternative that matches,
    else one character on."""
    out, i, n = [], 0, len(text)
    while i < n:
        hit = next((t for t in (SOT, EOT) + CONTRACTIONS
                    if text[i:i + len(t)].lower() == t), None)
        ch = text[i]
        if hit is not None:
            j = i + len(hit)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif not ch.isspace():
            j = i + 1
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    """CLIP's BPE over a merges file (``.txt`` or ``.txt.gz``)."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT, EOT])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {SOT: SOT, EOT: EOT}
        self.sot = self.encoder[SOT]
        self.eot = self.encoder[EOT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = " ".join(basic_clean(text).split()).lower()
        ids: List[int] = []
        for token in split_words(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids


def fallback_tokenize(text: str) -> List[int]:
    """A deterministic hash of the UTF-8 bytes into the CLIP id space (NOT
    semantically CLIP: pair it with random weights)."""
    return [(b * 191 + i * 7) % (VOCAB - 2)
            for i, b in enumerate(text.encode())][:CONTEXT - 2]


def tokenize(texts: Union[str, Sequence[str]],
             tokenizer: Optional[SimpleTokenizer] = None) -> np.ndarray:
    """texts -> int32 [N, 77]: start token, ids (truncated), end token,
    zero padding (open_clip.tokenize)."""
    if isinstance(texts, str):
        texts = [texts]
    sot = VOCAB - 2 if tokenizer is None else tokenizer.sot
    eot = VOCAB - 1 if tokenizer is None else tokenizer.eot
    out = np.zeros((len(texts), CONTEXT), np.int32)
    for i, t in enumerate(texts):
        ids = tokenizer.encode(t) if tokenizer else fallback_tokenize(t)
        ids = [sot] + list(ids[:CONTEXT - 2]) + [eot]
        out[i, :len(ids)] = ids
    return out


# ---- the text tower ----------------------------------------------------------


class CLIPTextEncoder:
    """Weights as a dict of tensors; call with int tokens [77] or [N, 77] ->
    unit features [EMBED] or [N, EMBED]."""

    def __init__(self, w: Dict[str, torch.Tensor]):
        self.w = w

    @property
    def device(self) -> torch.device:
        return self.w["text_proj"].device

    def __call__(self, tokens) -> torch.Tensor:
        w = self.w
        if not torch.is_tensor(tokens):
            tokens = torch.from_numpy(np.asarray(tokens))
        tokens = tokens.to(self.device, torch.int64)
        if tokens.dim() == 1:
            return self(tokens[None])[0]
        t = w["token_embedding"][tokens] + w["t_pos_embedding"]
        mask = torch.triu(torch.full((CONTEXT, CONTEXT), float("-inf"),
                                     device=self.device), diagonal=1)
        for i in range(T_LAYERS):
            t = _block(t, w, i, width=T_WIDTH, heads=T_HEADS, attn_mask=mask)
        t = _layernorm(t, w["ln_final_g"], w["ln_final_b"])
        # pool at the EOT token, the highest id of each row
        rows = torch.arange(tokens.shape[0], device=self.device)
        feat = t[rows, torch.argmax(tokens, dim=-1)] @ w["text_proj"]
        return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


def load_text_encoder(path: str, device="cuda") -> CLIPTextEncoder:
    """The text tower from ``convert_open_clip_text``'s ``.npz`` (or one
    file holding both towers: its ``t_blk`` keys are the text blocks, the
    bare ``blk`` keys and the image keys are skipped)."""
    device = resolve_device(device)
    w = {}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("t_blk"):
                w[k[2:]] = data[k]
            elif not k.startswith("blk") and k not in IMAGE_KEYS:
                w[k] = data[k]
    return CLIPTextEncoder(_tensors(w, device))


def random_text_encoder(seed: int = 1, device="cuda") -> CLIPTextEncoder:
    """The JAX package's fixed-seed random text tower, drawn from the same
    numpy stream in the same order (NOT semantically CLIP)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.02):
        return rng.normal(0, scale, shape).astype(np.float32)

    ones = np.ones(T_WIDTH, np.float32)
    zeros = np.zeros(T_WIDTH, np.float32)
    w = {
        "token_embedding": r(VOCAB, T_WIDTH),
        "t_pos_embedding": r(CONTEXT, T_WIDTH),
        "ln_final_g": ones,
        "ln_final_b": zeros,
        "text_proj": r(T_WIDTH, EMBED),
    }
    for i in range(T_LAYERS):
        p = f"blk{i}_"
        w.update({
            p + "ln1_g": ones, p + "ln1_b": zeros,
            p + "ln2_g": ones, p + "ln2_b": zeros,
            p + "attn_w": r(T_WIDTH, 3 * T_WIDTH),
            p + "attn_b": np.zeros(3 * T_WIDTH, np.float32),
            p + "attn_out_w": r(T_WIDTH, T_WIDTH),
            p + "attn_out_b": zeros,
            p + "mlp1_w": r(T_WIDTH, 4 * T_WIDTH),
            p + "mlp1_b": np.zeros(4 * T_WIDTH, np.float32),
            p + "mlp2_w": r(4 * T_WIDTH, T_WIDTH),
            p + "mlp2_b": zeros,
        })
    return CLIPTextEncoder(_tensors(w, device))


def convert_open_clip_text(state_dict, out_path: str) -> None:
    """An open_clip ViT-B-32 text state dict (token_embedding.weight,
    positional_embedding, transformer.resblocks.{i}.*, ln_final,
    text_projection) -> the tower's ``.npz``."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    out = {
        "token_embedding": sd["token_embedding.weight"],
        "t_pos_embedding": sd["positional_embedding"],
        "ln_final_g": sd["ln_final.weight"],
        "ln_final_b": sd["ln_final.bias"],
        "text_proj": sd["text_projection"],
    }
    for i in range(T_LAYERS):
        # t_ prefix: no collision with the image tower's keys
        out.update(_block_arrays(sd.__getitem__,
                                 f"transformer.resblocks.{i}.", f"t_blk{i}_"))
    np.savez(out_path, **out)


def get_text_features(text: str, *, weights_path: Optional[str] = None,
                      bpe_path: Optional[str] = None, seed: int = 1,
                      device="cuda") -> torch.Tensor:
    """A prompt -> its unit features [EMBED], without a gradient."""
    device = resolve_device(device)
    tok = SimpleTokenizer(bpe_path) if bpe_path else None
    tokens = tokenize(text, tok)[0]
    enc = (load_text_encoder(weights_path, device=device) if weights_path
           else random_text_encoder(seed, device=device))
    with torch.no_grad():
        return enc(tokens)
