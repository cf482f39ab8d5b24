"""talco_long_roofline: talco_roofline's share (the same formula and
peaks, roofline.bound_s over the window's kernel time) in a window whose
card launches were all long (the batcher's `long_launches` equal to its
`launches`), so that it reads the long route's work whatever implements
it. None where any launch of the window was not long, where the card
made no launch, or where talco_roofline has no reading."""
from msabench import spec


def read(rec):
    st = rec["stats"]
    launches = st.get("launches", 0)
    if launches <= 0 or st.get("long_launches") != launches:
        return None
    return spec.reader("talco_roofline")(rec)
