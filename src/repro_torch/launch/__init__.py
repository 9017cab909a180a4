"""Entry points of the port: serving (``serve``) and what of a config one
card holds (``one_card``)."""
