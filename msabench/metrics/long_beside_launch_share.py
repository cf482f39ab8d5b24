"""long_beside_launch_share: % of the window's long launches that the
batcher issued while an earlier long launch of the same round, on another
of the device's streams, had not finished (the program's
`count.launches_long_beside` over `count.launches_long`). None where the
program wrote no such counters, or the window made no long launch."""


def read(rec):
    st = rec["stats"]
    beside = st.get("count.launches_long_beside")
    launches = st.get("count.launches_long")
    if beside is None or not launches:
        return None
    return 100.0 * beside / launches
