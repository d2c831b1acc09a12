"""Host-clock milliseconds per field of the per-field set-up inside the
window: the union of the program's ``hz.coefficients``, ``hz.coarse_setup``
and ``hz.lambda_max`` spans (nested ones counted once: the coarse "mg"
set-up computes coefficients and lambda_max inside its own span), over the
window's ``hzbench.solve`` ranges (a new field before every solve)."""

from hzbench.spans import _say, outermost, per_unit

NAME = "field_setup_ms.solve_field"
SPANS = ("hz.coefficients", "hz.coarse_setup", "hz.lambda_max")


def read(run):
    def total(spans):
        found = [s for name in SPANS for s in spans.get(name, [])]
        if not found:
            _say(NAME, f"no {list(SPANS)} span in the window")
            return None
        return sum(t1 - t0 for t0, t1 in outermost(found)) / 1e3

    return per_unit(run, NAME, "hzbench.solve", total)
