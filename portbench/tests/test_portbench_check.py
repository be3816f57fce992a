"""The comparison that decides ``correct``, on hand-made outputs."""

from portbench import check

GFF = """##gff-version 3
##PAF\tp1\t100\t0\t100\t+\tc1\t1000\t10\t310\t90\t100\t0\tAS:i:5
c1\tminiprot\tmRNA\t11\t310\t5\t+\t.\tID=MP000007;Rank=1;Target=p1 1 100
c1\tminiprot\tCDS\t11\t310\t5\t+\t0\tParent=MP000007;Rank=1;Target=p1 1 100
##PAF\tp1\t100\t0\t100\t-\tc2\t1000\t10\t310\t90\t100\t0\tAS:i:5
c2\tminiprot\tmRNA\t11\t310\t5\t-\t.\tID=MP000008;Rank=2;Target=p1 1 100
##PAF\tp2\t50\t0\t50\t+\tc1\t1000\t500\t650\t45\t50\t0\tAS:i:3
c1\tminiprot\tmRNA\t501\t650\t3\t+\t.\tID=MP000009;Rank=1;Target=p2 1 50
"""


def test_split_and_renumber():
    b = check.split_blocks(GFF)
    assert set(b) == {"p1", "p2"}
    assert "ID=#1" in b["p1"] and "Parent=#1" in b["p1"]
    assert "ID=#2" in b["p1"]
    assert "ID=#1" in b["p2"] and "MP0000" not in b["p2"]


def test_numbering_does_not_matter_the_content_does():
    ref = check.split_blocks(GFF.replace("MP00000", "MP10000"))
    same = check.split_blocks(GFF)
    assert check.count_differing(ref, [same])[0] == 0
    moved = check.split_blocks(GFF.replace("\t501\t650\t", "\t501\t651\t"))
    assert check.count_differing(ref, [same, moved]) == (1, [(1, "p2")])
    dropped = check.split_blocks(GFF.split("##PAF\tp2")[0])
    assert check.count_differing(ref, [dropped])[0] == 1


def test_sample_draws_from_the_seed_and_keeps_the_longest():
    prots = [(f"q{i}", b"A" * (10 + i % 7)) for i in range(100)]
    prots.append(("long", b"A" * 1000))
    traffic = {"check_sample": 10, "check_longest": 1}
    a = check.sample(prots, traffic, 2**31 + 11)
    assert a == check.sample(prots, traffic, 2**31 + 11)
    assert a != check.sample(prots, traffic, 2**31 + 12)
    assert ("long", b"A" * 1000) in a and 10 <= len(a) <= 11
