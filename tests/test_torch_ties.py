"""When two runs agree up to rounding ties: one rule for a search result
whose run mixed two implementations' rounding (a snapshot resumed by
the other package, or on the other device) against a run of one
implementation. ``tests/test_torch_serving.py`` applies it across
packages and ``chip_smoke.py`` across devices; the tests below pin it.

Distinct designs whose scores differ by an ulp (the same chiplets in
other slots, summed in another order) keep, replace or drop each other
in an archive or as the incumbent, and on which side the ulp falls
differs between implementations. Nothing else may differ."""
import numpy as np
import pytest

TIE_RTOL = 1e-13      # two scores of one evaluator this close are a tie


def tie_groups(enc, vec, rtol: float):
    """Rows grouped by objective vector: sorted lexicographically, a row
    joins the group before it when its vector is within ``rtol`` of that
    group's first. ``[(vector, [encoding rows])]``."""
    enc = np.atleast_2d(np.asarray(enc))
    vec = np.asarray(vec, np.float64).reshape(len(enc), -1)
    out = []
    for i in np.lexsort(vec.T[::-1]):
        if out and np.allclose(vec[i], out[-1][0], rtol=rtol, atol=0):
            out[-1][1].append(enc[i])
        else:
            out.append((vec[i], [enc[i]]))
    return out


def assert_same_up_to_ties(enc, vec, ref_enc, ref_vec, rtol: float = 1e-6,
                           score=None) -> int:
    """Designs (frontier rows, or an incumbent as one row with its cost as
    its vector) of a mixed run against the single-implementation run's:
    as many points, their vectors within ``rtol``, and at each point only
    designs the reference holds there. Distinct designs whose scores
    differ by an ulp (the same chiplets in other slots, summed in another
    order) keep, replace or drop each other, and on which side the ulp
    falls differs between implementations; so where ``score`` is given
    (rows -> vectors, one evaluator for both sides), a design the
    reference does not hold at a point is accepted when it scores within
    ``TIE_RTOL`` of one of the reference's designs there. Returns the
    number of designs so accepted."""
    got, ref = tie_groups(enc, vec, rtol), tie_groups(ref_enc, ref_vec, rtol)
    assert len(got) == len(ref), f"{len(got)} points vs {len(ref)}"
    admitted = 0
    for (v, rows), (rv, rrows) in zip(got, ref):
        np.testing.assert_allclose(v, rv, rtol=rtol, atol=0)
        held = {r.tobytes() for r in rrows}
        other = [r for r in rows if r.tobytes() not in held]
        if not other:
            continue
        assert score is not None, (
            f"{len(other)} design(s) at {v} not held by the reference")
        s = np.asarray(score(np.stack(other + rrows)), np.float64)
        s = s.reshape(len(other) + len(rrows), -1)
        for i, r in enumerate(other):
            assert any(np.allclose(s[i], t, rtol=TIE_RTOL, atol=0)
                       for t in s[len(other):]), (
                f"design {r} at {v} scores {s[i]}, not a tie of the "
                f"reference's {s[len(other):]}")
        admitted += len(other)
    return admitted


ENC = np.array([[1, 2], [3, 4], [5, 6]])
VEC = np.array([[1.0, 3.0], [2.0, 2.0], [3.0, 1.0]])


def _sum_score(enc):
    """A score under which [3, 4] and [4, 3] tie exactly."""
    return np.array([[e.sum(), 10.0 - e.sum()] for e in enc])


def test_equal_sets_agree_with_no_ties():
    assert assert_same_up_to_ties(ENC, VEC, ENC, VEC) == 0
    assert assert_same_up_to_ties(ENC[::-1], VEC[::-1], ENC, VEC) == 0


def test_fewer_designs_at_a_tied_point_agree():
    ref_enc = np.vstack([ENC, [[4, 3]]])
    ref_vec = np.vstack([VEC, [[2.0, 2.0 + 4e-16]]])
    assert assert_same_up_to_ties(ENC, VEC, ref_enc, ref_vec) == 0


def test_another_design_at_a_point_needs_a_score_that_ties():
    enc, vec = ENC.copy(), VEC.copy()
    enc[1], vec[1] = [4, 3], vec[1] + 4e-16
    with pytest.raises(AssertionError, match="not held by the reference"):
        assert_same_up_to_ties(enc, vec, ENC, VEC)
    assert assert_same_up_to_ties(enc, vec, ENC, VEC, score=_sum_score) == 1
    with pytest.raises(AssertionError, match="not a tie"):
        assert_same_up_to_ties(enc, vec, ENC, VEC,
                               score=lambda e: e[:, :1].astype(float))


def test_a_missing_or_moved_point_is_refused():
    with pytest.raises(AssertionError, match="2 points vs 3"):
        assert_same_up_to_ties(ENC[:2], VEC[:2], ENC, VEC)
    vec = VEC.copy()
    vec[2, 0] *= 1 + 1e-5
    with pytest.raises(AssertionError):
        assert_same_up_to_ties(ENC, vec, ENC, VEC)


def test_an_incumbent_is_a_one_row_set():
    best, cost = np.array([3, 4]), 1.7
    assert assert_same_up_to_ties(best[None], [[cost]], best[None],
                                  [[cost * (1 + 1e-15)]]) == 0
    assert assert_same_up_to_ties(
        np.array([[4, 3]]), [[cost]], best[None], [[cost]],
        score=lambda e: e.sum(1, keepdims=True).astype(float)) == 1
