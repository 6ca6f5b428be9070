"""OCR tool (reference ``daemon/tools/ocr/ocr_document.py``).

The reference's backend is macOS Vision via pyobjc (reference :39-40) —
macOS-only, flagged as a platform gap in SURVEY.md §7. This build uses a
Linux-portable backend chain with the IDENTICAL tool contract:
tesseract (via pytesseract) when available, else a clear structured error.
PDFs rasterize at 200 dpi via PyMuPDF when installed (reference :51-79);
page-range parsing and per-page + combined text match reference :171-310.
"""

from __future__ import annotations

import json
from pathlib import Path

from whisper_mlx_tpu_torch.serving.tools.base import missing_dependency, tool


def _parse_page_range(pages: str, n_pages: int) -> list[int]:
    """'1,3-5' → [0, 2, 3, 4] (0-based), clamped to document length."""
    if not pages:
        return list(range(n_pages))
    out: set[int] = set()
    for part in pages.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.update(range(int(lo) - 1, int(hi)))
        elif part:
            out.add(int(part) - 1)
    return sorted(p for p in out if 0 <= p < n_pages)


def _pdf_to_images(path: Path, pages: str):
    import fitz  # PyMuPDF

    doc = fitz.open(path)
    idxs = _parse_page_range(pages, doc.page_count)
    images = []
    for i in idxs:
        pix = doc[i].get_pixmap(dpi=200)
        images.append((i + 1, pix.tobytes("png")))
    return images


def _ocr_image_bytes(data: bytes) -> str:
    import io

    import pytesseract
    from PIL import Image

    return pytesseract.image_to_string(Image.open(io.BytesIO(data)))


@tool(
    name="ocr_document",
    description=(
        "Extract text from an image or PDF via OCR. For PDFs a page range "
        "like '1,3-5' can be given. Returns per-page and combined text."
    ),
    parameters={
        "path": {"type": "string", "description": "path to an image or PDF file"},
        "pages": {"type": "string", "description": "page range for PDFs, e.g. '1,3-5'"},
    },
    required=["path"],
)
def ocr_document(path: str, pages: str = "") -> str:
    p = Path(path)
    if not p.exists():
        return json.dumps({"error": f"file not found: {path}"})
    try:
        import pytesseract  # noqa: F401
    except ImportError:
        return missing_dependency("ocr_document", "pytesseract")

    try:
        if p.suffix.lower() == ".pdf":
            try:
                import fitz  # noqa: F401
            except ImportError:
                return missing_dependency("ocr_document", "pymupdf")
            page_images = _pdf_to_images(p, pages)
            results = [
                {"page": n, "text": _ocr_image_bytes(img)} for n, img in page_images
            ]
        else:
            results = [{"page": 1, "text": _ocr_image_bytes(p.read_bytes())}]
    except Exception as exc:
        return json.dumps({"error": f"OCR failed: {type(exc).__name__}: {exc}"})

    return json.dumps({
        "pages": results,
        "combined_text": "\n\n".join(r["text"] for r in results),
    })


TOOL = ocr_document
