"""One loop a kind of traffic mix (a mix file names its ``loop``)."""
