"""gate_card_pair_share: % of the window's pairs in levels that the level
gate sent to the batcher (the program's `count.pairs_card` over
`count.pairs_card` + `count.pairs_host`). None where the program wrote no
counters, or the window aligned no pair."""


def read(rec):
    st = rec["stats"]
    card, host = st.get("count.pairs_card"), st.get("count.pairs_host")
    if card is None or host is None or card + host <= 0:
        return None
    return 100.0 * card / (card + host)
