"""Serving configuration: the validated knob tier for the generation
service.

Copied from ``determined_tpu/serving/config.py`` so that one `serving:`
section validates identically in both packages: the whole tree is
checked up front with every problem named (a typo'd `page_size` must
fail at startup, not surface as a shape error deep inside the decode
step).
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, List

logger = logging.getLogger("determined_tpu_torch.serving")

#: Keys accepted in a config's `serving:` section.
KNOWN_SERVING_KEYS = {
    "model",
    "page_size",
    "num_pages",
    "max_pages_per_request",
    "max_batch_size",
    "max_new_tokens",
    "prefill_rows",
    "prefill_seq",
    "max_queue_depth",
    "default_deadline_s",
    "shed_retry_after_s",
    "max_prefills_per_iter",
    "eos_id",
    "decode_kernel",
    "prefix_cache",
    "speculation",
}

#: `fixture` is the pre-trained tiny model (``serving/fixture.py``).
KNOWN_MODELS = ("tiny", "small", "medium", "fixture")

KNOWN_DECODE_KERNELS = ("auto", "paged", "gather")

KNOWN_PREFIX_CACHE = ("on", "off")

KNOWN_SPECULATION_MODES = ("off", "ngram")

#: Keys accepted inside `serving.speculation`.
KNOWN_SPECULATION_KEYS = {"mode", "draft_len", "min_match"}

#: Hard cap on draft_len: verify rides one static-shape decode iteration
#: with Q = draft_len + 1 rows per slot, so an unbounded draft_len would
#: quietly turn the decode step into a prefill-sized matmul.
MAX_DRAFT_LEN = 8

#: The reference's paged TPU kernel tiles K/V pages on the 128-lane axis,
#: so `decode_kernel: paged` demands a lane-aligned page_size. The port's
#: CUDA kernel takes any page_size, but the rule is kept so that one
#: config validates identically in both packages. Equal to
#: ``ops.paged_attention.LANE_GRANULE``.
PAGE_LANE_GRANULE = 128


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs for one generation-service replica.

    Pool geometry (`page_size` × `num_pages`) bounds total cached tokens;
    `max_pages_per_request` bounds one request's context (admission caps
    prompt + max_new_tokens to `min(model seq_len, pages × page_size)`).
    Page 0 of the pool is the scratch page inactive slots write to, so
    `num_pages - 1` pages are allocatable.
    """

    model: str = "tiny"
    #: tokens per KV page; smaller pages waste less on short tails but
    #: grow the page table.
    page_size: int = 128
    #: pool pages (page 0 reserved as the scratch page).
    num_pages: int = 65
    #: per-request page-table width: max context = this × page_size.
    max_pages_per_request: int = 8
    #: decode batch slots — the static decode-step batch dimension.
    max_batch_size: int = 8
    #: cap on any request's max_new_tokens.
    max_new_tokens: int = 256
    #: packed-prefill geometry (pack_sequences batch_size × seq_len).
    prefill_rows: int = 4
    prefill_seq: int = 256
    #: admission queue bound — beyond it requests are shed (429/503-class).
    max_queue_depth: int = 32
    #: deadline applied when a request names none (seconds, submit→done).
    default_deadline_s: float = 120.0
    #: Retry-After hint handed back with a shed.
    shed_retry_after_s: float = 1.0
    #: prefill/decode interleaving: at most this many packed-prefill
    #: batches are admitted per engine iteration, so a prefill burst
    #: cannot starve in-flight decode latency.
    max_prefills_per_iter: int = 1
    #: end-of-sequence token id (negative = never stop on a token).
    eos_id: int = -1
    #: decode attention kernel: `auto` and `paged` read K/V through the
    #: page table (ops/paged_attention); `gather` gathers each slot's
    #: pages contiguous and runs the flash kernel. The DTPU_PAGED_ATTN
    #: env var overrides at engine build (0 = gather, 1 = paged).
    decode_kernel: str = "auto"
    #: radix-tree prefix cache over page identity (`on` / `off`):
    #: finished requests' full pages stay cached and later prompts that
    #: share them prefill only their tail.
    prefix_cache: str = "off"
    #: speculative decoding: `{"mode": "off"|"ngram", "draft_len": int,
    #: "min_match": int}`. DTPU_SPEC_DECODE overrides the mode at engine
    #: build (0 = off, 1 = ngram).
    speculation: Any = dataclasses.field(
        default_factory=lambda: {"mode": "off"}
    )

    @property
    def max_context(self) -> int:
        return self.max_pages_per_request * self.page_size

    @property
    def spec_mode(self) -> str:
        return dict(self.speculation or {}).get("mode", "off")

    @property
    def spec_draft_len(self) -> int:
        return int(dict(self.speculation or {}).get("draft_len", 4))

    @property
    def spec_min_match(self) -> int:
        return int(dict(self.speculation or {}).get("min_match", 2))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingConfig":
        errors = validate_serving(d)
        if errors:
            raise ValueError("invalid serving config: " + "; ".join(errors))
        return cls(**{k: d[k] for k in d})


def validate_serving(d: Any) -> List[str]:
    """Human-readable errors for a `serving:` section (empty = valid)."""
    errors: List[str] = []
    if not isinstance(d, dict):
        return ["serving must be an object"]
    for key in d:
        if key not in KNOWN_SERVING_KEYS:
            errors.append(
                f"serving: unknown key {key!r} "
                f"(one of: {', '.join(sorted(KNOWN_SERVING_KEYS))})"
            )
    model = d.get("model", "tiny")
    if model not in KNOWN_MODELS:
        errors.append(
            f"serving.model {model!r} unknown (one of {sorted(KNOWN_MODELS)})"
        )
    for key in (
        "page_size", "num_pages", "max_pages_per_request", "max_batch_size",
        "max_new_tokens", "prefill_rows", "prefill_seq", "max_queue_depth",
        "max_prefills_per_iter",
    ):
        v = d.get(key)
        if v is not None and (
            not isinstance(v, int) or isinstance(v, bool) or v < 1
        ):
            errors.append(f"serving.{key} must be an int >= 1")
    for key in ("default_deadline_s", "shed_retry_after_s"):
        v = d.get(key)
        if v is not None and (
            not isinstance(v, (int, float)) or isinstance(v, bool)
            or not math.isfinite(v) or v <= 0
        ):
            errors.append(f"serving.{key} must be a finite number > 0")
    eos = d.get("eos_id")
    if eos is not None and (not isinstance(eos, int) or isinstance(eos, bool)):
        errors.append("serving.eos_id must be an int (negative disables)")
    kernel = d.get("decode_kernel", "auto")
    if kernel not in KNOWN_DECODE_KERNELS:
        errors.append(
            f"serving.decode_kernel {kernel!r} unknown "
            f"(one of {sorted(KNOWN_DECODE_KERNELS)})"
        )
    pc = d.get("prefix_cache", "off")
    if pc not in KNOWN_PREFIX_CACHE:
        errors.append(
            f"serving.prefix_cache {pc!r} unknown "
            f"(one of {sorted(KNOWN_PREFIX_CACHE)})"
        )
    spec = d.get("speculation")
    if spec is not None:
        if not isinstance(spec, dict):
            errors.append("serving.speculation must be an object")
        else:
            for key in spec:
                if key not in KNOWN_SPECULATION_KEYS:
                    errors.append(
                        f"serving.speculation: unknown key {key!r} "
                        f"(one of: {', '.join(sorted(KNOWN_SPECULATION_KEYS))})"
                    )
            mode = spec.get("mode", "off")
            if mode not in KNOWN_SPECULATION_MODES:
                errors.append(
                    f"serving.speculation.mode {mode!r} unknown "
                    f"(one of {sorted(KNOWN_SPECULATION_MODES)})"
                )
            dl = spec.get("draft_len")
            if dl is not None and (
                not isinstance(dl, int) or isinstance(dl, bool)
                or not 1 <= dl <= MAX_DRAFT_LEN
            ):
                errors.append(
                    f"serving.speculation.draft_len must be an int in "
                    f"[1, {MAX_DRAFT_LEN}] (verify scores draft_len + 1 "
                    "positions in one static-shape decode iteration)"
                )
            mm = spec.get("min_match")
            if mm is not None and (
                not isinstance(mm, int) or isinstance(mm, bool) or mm < 1
            ):
                errors.append(
                    "serving.speculation.min_match must be an int >= 1"
                )
    page_size = d.get("page_size", 128)
    if (
        kernel == "paged"
        and isinstance(page_size, int) and page_size >= 1
        and page_size % PAGE_LANE_GRANULE
    ):
        # Caught at config time with the geometry named, as the
        # reference does (see PAGE_LANE_GRANULE).
        errors.append(
            f"serving.page_size ({page_size}) must be a multiple of the "
            f"flash block_k lane granule ({PAGE_LANE_GRANULE}) for "
            "decode_kernel: paged — use a lane-aligned page_size or "
            "decode_kernel: gather"
        )
    # Cross-field geometry: admission relies on these invariants.
    num_pages = d.get("num_pages", 65)
    per_req = d.get("max_pages_per_request", 8)
    if (
        isinstance(num_pages, int) and isinstance(per_req, int)
        and num_pages >= 2 and per_req >= 1 and per_req > num_pages - 1
    ):
        errors.append(
            "serving.max_pages_per_request must fit the allocatable pool "
            "(num_pages - 1; page 0 is the scratch page)"
        )
    if isinstance(num_pages, int) and 0 < num_pages < 2:
        errors.append(
            "serving.num_pages must be >= 2 (page 0 is reserved as the "
            "scratch page)"
        )
    # Advisory, not an error (a deliberately oversubscribed pool is a
    # valid way to run — admission sheds): warn when a FULL batch of
    # max-context requests cannot hold pages simultaneously, i.e.
    # num_pages - 1 < max_batch_size × ceil(max_context / page_size).
    batch = d.get("max_batch_size", 8)
    if (
        not errors
        and isinstance(num_pages, int) and isinstance(per_req, int)
        and isinstance(batch, int)
        and num_pages - 1 < batch * per_req
    ):
        logger.warning(
            "serving: pool of %d allocatable pages cannot admit a full "
            "batch (%d slots x %d pages/request = %d); requests will be "
            "queued or shed under load",
            num_pages - 1, batch, per_req, batch * per_req,
        )
    return errors
