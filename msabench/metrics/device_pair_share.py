"""device_pair_share: % of the non-empty pairs handed to the batcher that
the card resolved (the batcher's pairs_on_device over pairs less
zero_length; the rest the host stole or the ladder deferred)."""


def read(rec):
    st = rec["stats"]
    total = st.get("pairs", 0) - st.get("zero_length", 0)
    if total <= 0:
        return None
    return 100.0 * st.get("pairs_on_device", 0) / total
