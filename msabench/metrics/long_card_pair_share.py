"""long_card_pair_share: % of the window's long pairs (a side above the
2048-column bucket) whose final result came from the card, not from the
host that stole them (the program's `count.pairs_long_card` over
`count.pairs_long_card` + `count.pairs_long_host`). None where the
program wrote no such counters, or the window finished no long pair."""


def read(rec):
    st = rec["stats"]
    card = st.get("count.pairs_long_card")
    host = st.get("count.pairs_long_host")
    if card is None or host is None or card + host <= 0:
        return None
    return 100.0 * card / (card + host)
