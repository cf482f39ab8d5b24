"""prep_native_pair_share: % of the window's pairs whose level prep ran in
the program's native level prep (the program's `count.pairs_prep_native`
over `count.pairs_prep_native` + `count.pairs_prep_py`). None where the
program wrote no such counters, or the window prepped no pair."""


def read(rec):
    st = rec["stats"]
    native = st.get("count.pairs_prep_native")
    py = st.get("count.pairs_prep_py")
    if native is None or py is None or native + py <= 0:
        return None
    return 100.0 * native / (native + py)
