"""Share of the distinct captions looked up in the caption memo that it did
not hold: the program's text.memo_misses over text.memo_hits plus
text.memo_misses, over the traced stretch."""
from portbench import program_trace

UNIT = "%"


def read(m, variant: str):
    r = program_trace.records(m)
    if r is None:
        return None
    hits, misses = r.counted("text.memo_hits") or 0, r.counted("text.memo_misses") or 0
    if not hits + misses:
        return None
    return 100.0 * misses / (hits + misses)
