"""Dependency-free minimal .xlsx writer for the per-class metric table
(a copy of `sodt_tpu/utils/xlsx.py`).

Columns name, seen, n_targets, P*100, R*100, mAP50*100, mAP*100; the first
row is the 'all' aggregate. An xlsx file is a zip of a few fixed XML parts
plus one worksheet, so the stdlib writes it: numbers as native numeric
cells, text as inline strings. Readable by Excel / LibreOffice / openpyxl /
pandas.
"""

from __future__ import annotations

import zipfile
from xml.sax.saxutils import escape

__all__ = ["write_xlsx", "write_per_class_xlsx"]

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col(j: int) -> str:
    """0-based column index -> A1-style column letters."""
    s = ""
    j += 1
    while j:
        j, r = divmod(j - 1, 26)
        s = chr(ord("A") + r) + s
    return s


def _cell(ref: str, v) -> str:
    if isinstance(v, bool):  # bools are ints in Python; keep them textual
        v = str(v)
    if isinstance(v, (int, float)):
        return f'<c r="{ref}"><v>{v}</v></c>'
    return (f'<c r="{ref}" t="inlineStr"><is><t>{escape(str(v))}</t></is>'
            "</c>")


def write_xlsx(path, rows, sheet_name: str = "Sheet1") -> None:
    """Write ``rows`` (iterable of lists of str/int/float) as a one-sheet
    .xlsx workbook at ``path``."""
    body = []
    for i, row in enumerate(rows):
        cells = "".join(_cell(f"{_col(j)}{i + 1}", v)
                        for j, v in enumerate(row))
        body.append(f'<row r="{i + 1}">{cells}</row>')
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>'
             + "".join(body) + "</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml",
                   _WORKBOOK.format(name=escape(sheet_name)))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def write_per_class_xlsx(metrics: dict, names, path) -> None:
    """The per-class workbook: row 1 is the 'all' aggregate, one row per
    evaluated class after; percentages *100."""
    seen = int(metrics.get("seen", 0))
    nt = metrics.get("nt", [])
    rows = [["all", seen, int(sum(nt)),
             metrics.get("mp", 0.0) * 100, metrics.get("mr", 0.0) * 100,
             metrics.get("map50", 0.0) * 100, metrics.get("map", 0.0) * 100]]
    for c, v in sorted(metrics.get("per_class", {}).items()):
        nm = names[c] if names and c < len(names) else str(c)
        rows.append([nm, seen, int(nt[c]) if c < len(nt) else 0,
                     v["p"] * 100, v["r"] * 100,
                     v["ap50"] * 100, v["ap"] * 100])
    write_xlsx(path, rows, sheet_name="per_class")
