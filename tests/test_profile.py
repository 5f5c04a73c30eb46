"""Profile stage: parsing, filtering rounds, EM, abundances, CAMI output."""

import math
import os

import numpy as np
import pytest

from taxor_jax.profile.profile import (
    ProfileConfig,
    SearchResult,
    calculate_higher_rank_abundances,
    calculate_log_likelihoods,
    count_unique_ambiguous_mappings_per_reference,
    expectation_maximization,
    filter_ref_associations,
    get_refs_with_uniquely_mapping_reads,
    parse_search_results,
    remove_low_confidence_references,
    remove_matches_to_nonunique_refs,
    tax_profile,
)

HEADER = ("#QUERY_NAME\tACCESSION\tREFERENCE_NAME\tTAXID\tREF_LEN\t"
          "QUERY_LEN\tQHASH_COUNT\tQHASH_MATCH\tTAX_STR\tTAX_ID_STR\n")

TAX_A = "k__V;p__P1;c__C1;o__O1;f__F1;g__G1;s__S A"
TID_A = "1;2;3;4;5;6;100"
TAX_B = "k__V;p__P1;c__C1;o__O1;f__F1;g__G2;s__S B"
TID_B = "1;2;3;4;5;7;200"


def row(read, acc, taxid, ref_len, qlen, qcount, qmatch, tax, tids):
    return (f"{read}\t{acc}\tOrg\t{taxid}\t{ref_len}\t{qlen}\t{qcount}\t"
            f"{qmatch}\t{tax}\t{tids}\n")


def nohit_row(read, qlen):
    return f"{read}\t-\t-\t-\t-\t{qlen}\n"


def write_search(tmp_path, rows):
    p = os.path.join(str(tmp_path), "search.tsv")
    with open(p, "w") as fh:
        fh.write(HEADER)
        fh.writelines(rows)
    return p


class TestParse:
    def test_basic(self, tmp_path):
        p = write_search(tmp_path, [
            row("r1 extra words", "ACC_A", "100", 5000, 1000, 50, 40,
                TAX_A, TID_A),
            row("r1 extra words", "ACC_B", "200", 6000, 1000, 50, 38,
                TAX_B, TID_B),
            nohit_row("r2", 800),
        ])
        results, taxpath = parse_search_results(p)
        assert set(results) == {"r1", "r2"}  # id cut at first space
        assert len(results["r1"]) == 2
        assert results["r2"][0].accession_id == "-"
        assert results["r2"][0].query_len == 800
        assert taxpath["ACC_A"] == (TID_A, TAX_A)

    def test_dash_not_added_after_match(self, tmp_path):
        p = write_search(tmp_path, [
            row("r1", "ACC_A", "100", 5000, 1000, 50, 40, TAX_A, TID_A),
            nohit_row("r1", 1000),
        ])
        results, _ = parse_search_results(p)
        assert len(results["r1"]) == 1

    def test_dash_kept_if_first(self, tmp_path):
        # quirk: leading '-' row survives later matches
        p = write_search(tmp_path, [
            nohit_row("r1", 1000),
            row("r1", "ACC_A", "100", 5000, 1000, 50, 40, TAX_A, TID_A),
        ])
        results, _ = parse_search_results(p)
        assert [e.accession_id for e in results["r1"]] == ["-", "ACC_A"]


class TestFiltering:
    def test_round1(self):
        results = {
            "r1": [SearchResult("r1", "A", "100", 10, 10, 5, 5)],
            "r2": [SearchResult("r2", "A", "100", 10, 10, 5, 4),
                   SearchResult("r2", "B", "200", 10, 10, 5, 4)],
            "r3": [SearchResult("r3", "B", "200", 10, 10, 5, 4),
                   SearchResult("r3", "C", "300", 10, 10, 5, 4)],
        }
        uniq = get_refs_with_uniquely_mapping_reads(results)
        assert uniq == {"A"}
        remove_matches_to_nonunique_refs(results, uniq)
        # r2: B dropped (A has unique reads); r3: no entry unique -> kept
        assert [e.accession_id for e in results["r2"]] == ["A"]
        assert [e.accession_id for e in results["r3"]] == ["B", "C"]

    def test_round2_thresholds(self):
        results = {}
        # ref A: 3 unique reads; ref B: 1 unique read
        for i in range(3):
            results[f"ua{i}"] = [SearchResult(f"ua{i}", "A", "1", 10, 10, 5, 5)]
        results["ub0"] = [SearchResult("ub0", "B", "2", 10, 10, 5, 5)]
        results["amb"] = [SearchResult("amb", "A", "1", 10, 10, 5, 4),
                          SearchResult("amb", "B", "2", 10, 10, 5, 4)]
        counts = count_unique_ambiguous_mappings_per_reference(results)
        assert counts["A"] == [3, 1]
        assert counts["B"] == [1, 1]
        remove_low_confidence_references(results, counts, 3, 0.01)
        assert [e.accession_id for e in results["amb"]] == ["A"]

    def _explained_scenario(self):
        """A: 1 unique read + 59 reads shared with B (B has nothing else).

        Reference behavior (quirk, taxor_profile.cpp:349-383): the 95%
        co-mapping test is evaluated on the STRONGER-or-equal ref's read
        set and, when it passes, the stronger ref is the one replaced.
        Here A.unique(1) > B.unique(0) -> branch 1 checks A.all - shared
        = 60-59 = 1 < int(0.05*60) = 3 -> explained[A] = B.
        Also note the int truncation: with < 20 total reads the slack is
        int(0.05*all) = 0 and nothing is ever explained.
        """
        results = {"u0": [SearchResult("u0", "A", "1", 100, 10, 5, 5)]}
        for i in range(59):
            results[f"s{i}"] = [SearchResult(f"s{i}", "A", "1", 100, 10, 5, 4),
                                SearchResult(f"s{i}", "B", "2", 50, 10, 5, 4)]
        return results

    def test_ref_association_explains_stronger_by_weaker(self):
        results = self._explained_scenario()
        taxa = filter_ref_associations(results)
        assert "B" in taxa and "A" not in taxa
        # shared reads: the A match is erased (B already among accs)
        for i in range(59):
            assert [e.accession_id for e in results[f"s{i}"]] == ["B"]
        # the unique read keeps its A match (single matches untouched)
        assert [e.accession_id for e in results["u0"]] == ["A"]

    def test_small_read_sets_never_explained(self):
        results = {"u0": [SearchResult("u0", "A", "1", 100, 10, 5, 5)]}
        for i in range(10):
            results[f"s{i}"] = [SearchResult(f"s{i}", "A", "1", 100, 10, 5, 4),
                                SearchResult(f"s{i}", "B", "2", 50, 10, 5, 4)]
        taxa = filter_ref_associations(results)
        assert set(taxa) == {"A", "B"}

    def test_reassigned_keeps_stale_taxid(self):
        # reassignment changes accession/ref_len but NOT tax_id (quirk,
        # taxor_profile.cpp:442-444)
        results = self._explained_scenario()
        # one extra read maps to A and C only: its A match is reassigned
        # to B (A explained by B, B not among its accs)
        results["x0"] = [SearchResult("x0", "A", "1", 100, 10, 5, 4),
                        SearchResult("x0", "C", "3", 60, 10, 5, 4)]
        filter_ref_associations(results)
        accs = [e.accession_id for e in results["x0"]]
        assert "B" in accs
        e = next(e for e in results["x0"] if e.accession_id == "B")
        assert e.tax_id == "1"  # stale: still A's taxid
        assert e.ref_len == 50  # updated to B's length


class TestEM:
    def test_likelihoods(self):
        results = {
            "r": [SearchResult("r", "A", "1", 10, 10, 10, 8),
                  SearchResult("r", "B", "2", 10, 10, 10, 2)],
        }
        ll = calculate_log_likelihoods(results)
        sum_ratio = 0.8 + 0.2
        assert math.isclose(ll["r"]["A"],
                            math.log(8) - math.log(10) - math.log(sum_ratio))

    def test_single_match_likelihood_zero(self):
        results = {"r": [SearchResult("r", "A", "1", 10, 10, 10, 8)]}
        ll = calculate_log_likelihoods(results)
        assert ll["r"]["A"] == 0.0

    def test_em_assigns_best(self):
        taxa = {"A": 1000, "B": 1000}
        results = {
            "amb": [SearchResult("amb", "A", "1", 1000, 100, 10, 9),
                    SearchResult("amb", "B", "2", 1000, 100, 10, 3)],
            "u0": [SearchResult("u0", "A", "1", 1000, 100, 10, 10)],
        }
        abund, profile = expectation_maximization(100, taxa, results)
        assert [e.accession_id for e in profile["amb"]] == ["A"]
        assert abund["A"] > abund["B"]
        assert "unclassified" in abund

    def test_em_erases_last_entry_each_iteration(self):
        # the min_post-never-updated quirk: LAST scored entry erased
        taxa = {"A": 1000, "B": 1000, "C": 1000}
        entries = [SearchResult("r", "A", "1", 1000, 100, 10, 9),
                   SearchResult("r", "B", "2", 1000, 100, 10, 5),
                   SearchResult("r", "C", "3", 1000, 100, 10, 7)]
        results = {"r": list(entries)}
        expectation_maximization(1, taxa, results)
        # after 1 iteration, C (last) was erased even though B is worse
        assert [e.accession_id for e in results["r"]] == ["A", "B"]

    def test_unclassified_abundance(self):
        taxa = {"A": 1000}
        results = {
            "u0": [SearchResult("u0", "A", "1", 1000, 300, 10, 10)],
            "n0": [SearchResult("n0", "-", "", 0, 700, 0, 0)],
        }
        abund, _ = expectation_maximization(100, taxa, results)
        assert math.isclose(abund["A"], 0.3, rel_tol=1e-6)
        assert math.isclose(abund["unclassified"], 0.7, rel_tol=1e-6)


class TestHigherRanks:
    def test_aggregation(self):
        taxpath = {"ACC_A": (TID_A, TAX_A), "ACC_B": (TID_B, TAX_B)}
        abund = {"ACC_A": 0.6, "ACC_B": 0.4}
        rp = calculate_higher_rank_abundances(abund, taxpath)
        assert math.isclose(rp["100"].percentage, 0.6)
        assert math.isclose(rp["200"].percentage, 0.4)
        # shared family F1 aggregates both
        assert math.isclose(rp["5"].percentage, 1.0)
        assert rp["5"].rank == "family"
        assert rp["100"].rank == "species"
        assert rp["100"].taxid_string == "1|2|3|4|5|6|100"
        assert rp["100"].taxname_string == "V|P1|C1|O1|F1|G1|S A"


class TestEndToEnd:
    def test_full_profile(self, tmp_path):
        rows = []
        # 5 unique reads to A, 4 ambiguous A/B, 1 unclassified
        for i in range(5):
            rows.append(row(f"u{i}", "ACC_A", "100", 5000, 1000, 50, 45,
                            TAX_A, TID_A))
        for i in range(4):
            rows.append(row(f"m{i}", "ACC_A", "100", 5000, 1000, 50, 40,
                            TAX_A, TID_A))
            rows.append(row(f"m{i}", "ACC_B", "200", 6000, 1000, 50, 35,
                            TAX_B, TID_B))
        rows.append(nohit_row("n0", 500))
        p = write_search(tmp_path, rows)

        report = os.path.join(str(tmp_path), "cami.profile")
        seqab = os.path.join(str(tmp_path), "seq.profile")
        binning = os.path.join(str(tmp_path), "binning.tsv")
        tax_profile(ProfileConfig(
            search_file=p, report_file=report,
            sequence_abundance_file=seqab, binning_file=binning,
            sample_id="sample1", threshold=0.001, em_steps=100,
        ))

        prof = open(report).read().splitlines()
        assert prof[0] == "@SampleID:sample1"
        assert prof[3] == "@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE"
        body = [l.split("\t") for l in prof[4:]]
        by_taxid = {r[0]: r for r in body}
        # only A survives (B has no unique reads -> round 1 removes it)
        assert "100" in by_taxid
        assert "200" not in by_taxid
        assert float(by_taxid["100"][4]) == 100.0

        seq = open(seqab).read().splitlines()
        uncls = [l for l in seq if l.startswith("unclassified")]
        assert len(uncls) == 1
        # 500 / 9500 of nucleotides unclassified
        assert abs(float(uncls[0].split("\t")[4]) - 100 * 500 / 9500) < 0.01

        binn = open(binning).read().splitlines()
        assert binn[2] == "@@SEQUENCEID\tTAXID"
        entries = dict(
            (l.split("\t")[0], l.split("\t")[1]) for l in binn[3:]
        )
        for i in range(5):
            assert entries[f"u{i}"] == "100"
        for i in range(4):
            assert entries[f"m{i}"] == "100"
        # unclassified read: empty taxid (reference prints default-empty
        # tax_id of the '-' Search_Result)
        assert entries["n0"] == ""
