"""Date arithmetic + filename templating for month-pair pathline runs.

Re-implementation of the reference date/YAML utilities
(reference src/Utils/Utils.hpp:6-120 toIntYMD/getTimeGapinSecond and
src/Utils/YamlGen.hpp:122-340 render_name / make_forward_month_pairs /
temp-YAML generation), used to chain pathline integrations across monthly
solution files (reference tutorial/pathLine.cpp:86-241).  Copy of
mops_tpu.utils.dates.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Tuple

_DAYS_IN_MONTH = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


@dataclasses.dataclass(frozen=True, order=True)
class YMD:
    year: int
    month: int
    day: int = 1

    @classmethod
    def parse(cls, text: str) -> "YMD":
        """Parse 'YYYY-MM-DD' / 'YYYY-MM' / compact 'YYYYMMDD'."""
        m = re.match(r"(\d{1,4})-(\d{1,2})(?:-(\d{1,2}))?", text)
        if m:
            return cls(int(m.group(1)), int(m.group(2)),
                       int(m.group(3) or 1))
        if text.isdigit() and len(text) == 8:
            return cls(int(text[:4]), int(text[4:6]), int(text[6:8]))
        raise ValueError(f"unparseable date: {text!r}")

    def to_int(self) -> int:
        """toIntYMD: YYYYMMDD integer (reference src/Utils/Utils.hpp)."""
        return self.year * 10000 + self.month * 100 + self.day

    def is_leap(self) -> bool:
        y = self.year
        return (y % 4 == 0 and y % 100 != 0) or (y % 400 == 0)

    def days_in_month(self) -> int:
        d = _DAYS_IN_MONTH[self.month - 1]
        return d + 1 if (self.month == 2 and self.is_leap()) else d

    def next_month(self) -> "YMD":
        if self.month == 12:
            return YMD(self.year + 1, 1, self.day)
        return YMD(self.year, self.month + 1, self.day)

    def prev_month(self) -> "YMD":
        if self.month == 1:
            return YMD(self.year - 1, 12, self.day)
        return YMD(self.year, self.month - 1, self.day)

    def ordinal(self) -> int:
        """Days since year 0 (proleptic, month-table based)."""
        y = self.year - 1
        days = y * 365 + y // 4 - y // 100 + y // 400
        for m in range(1, self.month):
            days += _DAYS_IN_MONTH[m - 1]
            if m == 2 and self.is_leap():
                days += 1
        return days + self.day

    def __str__(self) -> str:
        return f"{self.year:04d}-{self.month:02d}-{self.day:02d}"


def time_gap_seconds(a: YMD, b: YMD) -> int:
    """Whole-day gap in seconds between two dates (reference
    getTimeGapinSecond, src/Utils/Utils.hpp)."""
    return abs(b.ordinal() - a.ordinal()) * 86400


def render_name(template: str, date: YMD) -> str:
    """Filename templating with {year}/{month}/{day} placeholders
    (reference YamlGen::render_name, src/Utils/YamlGen.hpp)."""
    return (template
            .replace("{year}", f"{date.year:04d}")
            .replace("{month}", f"{date.month:02d}")
            .replace("{day}", f"{date.day:02d}"))


def make_forward_month_pairs(start: YMD, end: YMD) -> List[Tuple[YMD, YMD]]:
    """[(m0, m1), (m1, m2), ...] consecutive month pairs, inclusive of end
    (reference tutorial/pathLine.cpp make_forward_month_pairs)."""
    pairs = []
    cur = YMD(start.year, start.month, 1)
    stop = YMD(end.year, end.month, 1)
    while cur < stop:
        nxt = cur.next_month()
        pairs.append((cur, nxt))
        cur = nxt
    return pairs


def make_backward_month_pairs(start: YMD, end: YMD) -> List[Tuple[YMD, YMD]]:
    return [(b, a) for a, b in reversed(make_forward_month_pairs(end, start))]


def generate_pair_yaml(template_yaml: str, out_path: str,
                       front: YMD, back: YMD,
                       data_filename_template: str) -> str:
    """Write a stream YAML whose data substream holds the two month files of
    a pathline pair (reference YamlGen temp-YAML pair generation)."""
    with open(template_yaml) as f:
        text = f.read()
    f_name = render_name(data_filename_template, front)
    b_name = render_name(data_filename_template, back)
    text = re.sub(r"(filenames:\s*)\"[^\"]*\"(\s*\n(\s*)vars:)",
                  lambda m: f'{m.group(1)}["{f_name}", "{b_name}"]{m.group(2)}',
                  text, count=0)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path
