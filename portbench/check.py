"""How ``correct`` is decided: every answer of the window against the plain
reference on the same clip.

The numbers compared are the configuration's ``limits``: each one's reading
is the worst over all answers of the family's ``gaps`` of one answer against
its clip's reference (``families/<name>.py``), and each has the limit that
the configuration file gives it.  A non-finite answer reads infinity.  The
family's numbers and the configuration's limits have to name the same set: a
limit that no number reads, or a number with no limit, raises.
"""

from __future__ import annotations


def worst(cell, answers, refs: dict) -> dict:
    """answers: (clip index, vector, served score); refs: clip index -> the
    family's reference answer -> each number's worst reading.  Equal answers
    of one clip are read once."""
    out, seen = dict.fromkeys(cell.config["limits"], 0.0), set()
    for clip, vec, score in answers:
        key = (clip, vec.tobytes(), float(score))
        if key in seen:
            continue
        seen.add(key)
        read = cell.family.gaps(cell, vec, score, refs[clip])
        if read.keys() != out.keys():
            raise ValueError(f"{cell.family.__name__} reads {sorted(read)}, but the configuration of {cell.name} has limits "
                             f"for {sorted(out)}")
        for k, v in read.items():
            out[k] = max(out[k], v)
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every reading within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": readings[k], "limit": limit} for k, limit in limits.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table
