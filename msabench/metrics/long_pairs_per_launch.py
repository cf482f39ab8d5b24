"""long_pairs_per_launch: pairs a long launch holds, over the window (the
program's `count.pairs_long_launched` over `count.launches_long`, ladder
relaunches included). None where the program wrote no such counters, or
the window made no long launch."""


def read(rec):
    st = rec["stats"]
    pairs = st.get("count.pairs_long_launched")
    launches = st.get("count.launches_long")
    if pairs is None or not launches:
        return None
    return pairs / launches
